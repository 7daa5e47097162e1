"""cofusion_tpu_torch/ops/fusion.py against cofusion_tpu/ops/fusion.py on the
CPU: one store (the JAX map of frame 0), one frame (frame 2 at its
ground-truth pose).  Each stage takes the JAX package's inputs, carried
across, so a divergence is pinned to the stage that makes it.

Bars: surfel counts, valid masks, merge/append decisions and index maps
exact; float attributes rtol=1e-5, atol=1e-6 (a few float32 ops each; XLA
CPU contracts multiply-adds into FMAs, PyTorch does not).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu.config import CoFusionConfig
from cofusion_tpu.io.synthetic import make_sequence
from cofusion_tpu.ops import fusion as jfu
from cofusion_tpu.ops import preprocess as jpp
from cofusion_tpu.ops import rasterize as jrz
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch import convert
from cofusion_tpu_torch.ops import fusion as tfu
from cofusion_tpu_torch.ops import rasterize as trz

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
TICK = 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_tuple(t, j, names):
    for name, a, b in zip(names, t, j):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.fixture(scope="module")
def tcam(small_cam):
    """The port's CameraConfig equal to small_cam."""
    return tcfg.CameraConfig(**dataclasses.asdict(small_cam))


@pytest.fixture(scope="module")
def scene(small_cam):
    cfg = CoFusionConfig(camera=small_cam, max_models=1, max_surfels=1 << 17)
    frames, gt, _ = make_sequence(small_cam, 3, kind="orbit")
    bil = jax.jit(jpp.bilateral_filter)
    f0, f2 = frames[0], frames[2]
    d0 = jnp.asarray(f0["depth"])
    fs0 = jfu.make_frame_surfels(d0, bil(d0, 4.5), jnp.asarray(f0["rgb"], jnp.float32), small_cam, 1.0, 4.5)
    store = jfu.initialise(fs0, jnp.eye(4), 1 << 17, time=1)
    depth = np.array(f2["depth"])
    filtered = np.array(bil(jnp.asarray(depth), 4.5))
    rgb = np.array(f2["rgb"], np.float32)
    pose = np.asarray(gt[2], np.float32)
    fs = jfu.make_frame_surfels(
        jnp.asarray(depth), jnp.asarray(filtered), jnp.asarray(rgb), small_cam, 0.8, 4.5
    )
    imap = jrz.predict_indices(store, jnp.asarray(pose), small_cam, TICK, 200, 4.5)
    fused, aux = jfu.fuse(
        store, fs, jnp.asarray(depth), imap, jnp.ones(small_cam.shape, bool),
        jnp.asarray(pose), small_cam, cfg, TICK, 4.5, return_aux=True,
    )
    return dict(cfg=cfg, store=store, depth=depth, filtered=filtered, rgb=rgb, pose=pose,
                fs=fs, imap=imap, fused=fused, aux=aux)


def test_make_frame_surfels_matches(scene, tcam):
    s = scene
    out = tfu.make_frame_surfels(_t(s["depth"]), _t(s["filtered"]), _t(s["rgb"]), tcam, 0.8, 4.5)
    _assert_tuple(out, s["fs"], tfu.FrameSurfels._fields)


def test_initialise_matches(scene):
    s = scene
    fs = tfu.FrameSurfels(*(_t(a) for a in s["fs"]))
    pose = _t(s["pose"])
    out = tfu.initialise(fs, pose, 1 << 17, time=TICK)
    ref = jfu.initialise(s["fs"], jnp.asarray(s["pose"]), 1 << 17, time=TICK)
    _assert_tuple(out, ref, out._fields)


def test_fuse_matches(scene, tcam):
    s = scene
    out, aux = tfu.fuse(
        convert.store_from_numpy(tuple(np.array(a) for a in s["store"])),
        tfu.FrameSurfels(*(_t(a) for a in s["fs"])),
        _t(s["depth"]),
        trz.IndexMap(*(_t(a) for a in s["imap"])),
        torch.ones(tcam.shape, dtype=torch.bool),
        _t(s["pose"]), tcam, tcfg.CoFusionConfig(camera=tcam, max_models=1, max_surfels=1 << 17),
        TICK, 4.5, return_aux=True,
    )
    ref, ref_aux = s["fused"], s["aux"]
    n_merged = int((np.asarray(ref.last_time) == TICK).sum())
    assert n_merged > 1000 and int(ref.count) > int(s["store"].count)  # both paths exercised
    assert int(out.count) == int(ref.count)
    _assert_tuple(out, ref, out._fields)
    np.testing.assert_array_equal(aux.new_s.numpy(), np.asarray(ref_aux.new_s))
    np.testing.assert_array_equal(aux.dest.numpy(), np.asarray(ref_aux.dest))
    assert aux.phase == int(ref_aux.phase)


def test_overlay_imap_matches(scene, small_cam, tcam):
    s = scene
    ref_aux = s["aux"]
    aux = tfu.FuseAux(
        new_s=_t(ref_aux.new_s), dest=_t(ref_aux.dest).to(torch.int64),
        count=_t(ref_aux.count), phase=int(ref_aux.phase),
    )
    out = tfu.overlay_imap(
        convert.store_from_numpy(tuple(np.array(a) for a in s["fused"])),
        trz.IndexMap(*(_t(a) for a in s["imap"])), aux,
        tfu.FrameSurfels(*(_t(a) for a in s["fs"])), _t(s["pose"]), tcam, TICK,
    )
    ref = jfu.overlay_imap(s["fused"], s["imap"], ref_aux, s["fs"], jnp.asarray(s["pose"]), small_cam, TICK)
    _assert_tuple(out, ref, trz.IndexMap._fields)


@pytest.mark.parametrize("time,conf_threshold", [(TICK, 10.0), (30, 1.2)])
def test_clean_eval_matches(scene, small_cam, tcam, time, conf_threshold):
    """At tick 30 the unstable-timeout gate (age > 20, conf < threshold)
    drops part of the map; the duplicate and free-space gates run at both."""
    s = scene
    imap2 = jfu.overlay_imap(s["fused"], s["imap"], s["aux"], s["fs"], jnp.asarray(s["pose"]), small_cam, TICK)
    cleaned_j, keep_j = jfu.clean_eval(
        s["fused"], imap2, jnp.asarray(s["filtered"]), None, 0, jnp.asarray(s["pose"]),
        small_cam, s["cfg"], time, 200, conf_threshold, 3.0,
    )
    cleaned_t, keep_t = tfu.clean_eval(
        convert.store_from_numpy(tuple(np.array(a) for a in s["fused"])),
        trz.IndexMap(*(_t(a) for a in imap2)), _t(s["filtered"]), _t(s["pose"]),
        tcam, time, 200, torch.tensor(conf_threshold), 3.0,
    )
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    n = int(s["fused"].count)
    if time > TICK:
        assert 0.0 < np.asarray(keep_j)[:n].mean() < 1.0  # the timeout gate fires
    np.testing.assert_allclose(cleaned_t.conf.numpy(), np.asarray(cleaned_j.conf), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mask_id", [0, 1])
def test_masked_clean_eval_matches(scene, small_cam, tcam, mask_id):
    """The mask-mismatch penalty: a violated surfel whose pixel carries
    another model's id, at the observed depth, loses confidence.  The mask
    marks a band of the image as model 1; the free-space violations come
    from the filtered depth pulled 5 cm forward over half the image."""
    s = scene
    imap2 = jfu.overlay_imap(s["fused"], s["imap"], s["aux"], s["fs"], jnp.asarray(s["pose"]), small_cam, TICK)
    H, W = small_cam.shape
    mask = np.zeros((H, W), np.int32)
    mask[:, W // 3: 2 * W // 3] = 1
    depth = np.array(s["filtered"])
    depth[:, W // 2:] += 0.04
    cleaned_j, keep_j = jfu.clean_eval(
        s["fused"], imap2, jnp.asarray(depth), jnp.asarray(mask), mask_id, jnp.asarray(s["pose"]),
        small_cam, s["cfg"], TICK, 200, 1.2, 3.0,
    )
    cleaned_t, keep_t = tfu.clean_eval(
        convert.store_from_numpy(tuple(np.array(a) for a in s["fused"])),
        trz.IndexMap(*(_t(a) for a in imap2)), _t(depth), _t(s["pose"]),
        tcam, TICK, 200, torch.tensor(1.2), 3.0, mask=_t(mask), mask_id=torch.tensor(mask_id),
    )
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_allclose(cleaned_t.conf.numpy(), np.asarray(cleaned_j.conf), rtol=RTOL, atol=ATOL)
    # the penalty fired: confidences below the unmasked pass's
    plain_j, _ = jfu.clean_eval(
        s["fused"], imap2, jnp.asarray(depth), None, 0, jnp.asarray(s["pose"]),
        small_cam, s["cfg"], TICK, 200, 1.2, 3.0,
    )
    assert (np.asarray(cleaned_j.conf) < np.asarray(plain_j.conf)).sum() > 100
