"""cofusion_tpu_torch/ops/segmentation.py against cofusion_tpu/ops/segmentation.py
on the CPU, on numpy-seeded inputs and a synthetic 160x128 frame.

Bars:
  * integer results exact: SLIC assignments, connected components,
    upsampling, the CRF labels, superpixel counts, bounding boxes, has_new,
    medians (a median selects an input value);
  * float results to fp32 rounding, rtol=1e-5, atol=1e-6: superpixel means
    (block sums of <= S^2 terms reduced in another order), depth stats,
    the average confidence; the mean-field Q atol=5e-5 (its logits are sums
    of K ~ 300 terms of magnitude up to ~10, whose fp32 summation-order
    error is ~sqrt(K) ulp ~ 3e-5, carried through ten rounds), its argmax
    exact.
The superpixel size 6 leaves remainder strips at 160x128 (128 = 21*6 + 2),
which take the `_segment_sum` path; 16 divides 160x128 evenly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu.config import CoFusionConfig, SegmentationParams
from cofusion_tpu.io.synthetic import make_sequence
from cofusion_tpu.ops import segmentation as jsg
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch.ops import segmentation as tsg

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frame(small_cam):
    frames, _, _ = make_sequence(small_cam, 1, kind="orbit", moving_object=True)
    return frames[0]


def _cfgs(cam, S):
    j = CoFusionConfig(camera=cam, max_models=3, superpixel_size=S)
    t = tcfg.CoFusionConfig(
        camera=tcfg.CameraConfig(**dataclasses.asdict(cam)), max_models=3, superpixel_size=S
    )
    return j, t


@pytest.mark.parametrize("S", [6, 16])
def test_slic_assign_matches(frame, small_cam, S):
    jc, tc = _cfgs(small_cam, S)
    a_j = np.asarray(jax.jit(jsg.slic_assign, static_argnums=1)(jnp.asarray(frame["rgb"]), jc))
    a_t = tsg.slic_assign(_t(frame["rgb"]), tc).numpy()
    np.testing.assert_array_equal(a_t, a_j)
    # and SLIC moved off the regular grid
    base = (np.arange(small_cam.height)[:, None] // S).clip(max=small_cam.height // S - 1)
    assert (a_j // (small_cam.width // S) != base).any()


@pytest.fixture(scope="module", params=[6, 16])
def assigned(request, frame, small_cam):
    S = request.param
    jc, tc = _cfgs(small_cam, S)
    assign = np.asarray(jax.jit(jsg.slic_assign, static_argnums=1)(jnp.asarray(frame["rgb"]), jc))
    GH, GW = small_cam.height // S, small_cam.width // S
    return assign, (GH, GW, S), GH * GW


def test_downsample_mean_matches(frame, assigned):
    assign, grid, K = assigned
    rgb = np.asarray(frame["rgb"], np.float32)
    depth = np.asarray(frame["depth"])
    for img, thr in ((rgb, None), (depth, 0.02)):
        m_j, c_j = jsg.downsample_mean(jnp.asarray(img), jnp.asarray(assign), K, min_threshold=thr, grid=grid)
        m_t, c_t = tsg.downsample_mean(_t(img), _t(assign), grid, min_threshold=thr)
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=RTOL, atol=ATOL)
        # and the JAX package's scatter form, which the port does not keep
        m_s, _ = jsg.downsample_mean(jnp.asarray(img), jnp.asarray(assign), K, min_threshold=thr)
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_s), rtol=RTOL, atol=ATOL)


def test_downsample_mean_b_matches(assigned):
    assign, grid, K = assigned
    imgs = np.random.default_rng(3).uniform(0, 1, (3,) + assign.shape).astype(np.float32)
    out_t = tsg.downsample_mean_b(_t(imgs), _t(assign), grid)
    for g in (grid, None):
        out_j = jsg.downsample_mean_b(jnp.asarray(imgs), jnp.asarray(assign), K, grid=g)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)


def test_downsample_median_b_matches(assigned):
    """Exact: a median selects a value; ties (the quantised values repeat)
    keep their order through the stable two-pass sort."""
    assign, _, K = assigned
    rng = np.random.default_rng(4)
    imgs = np.round(rng.uniform(0, 1, (3,) + assign.shape), 2).astype(np.float32)
    imgs[1, :40] = 0.0
    out_j = jax.jit(jsg.downsample_median_b, static_argnums=2)(jnp.asarray(imgs), jnp.asarray(assign), K)
    out_t = tsg.downsample_median_b(_t(imgs), _t(assign), K)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_upsample_matches(assigned):
    assign, _, K = assigned
    vals = np.random.default_rng(5).integers(0, 255, K).astype(np.int32)
    np.testing.assert_array_equal(
        tsg.upsample(_t(vals), _t(assign)).numpy(),
        np.asarray(jsg.upsample(jnp.asarray(vals), jnp.asarray(assign))),
    )


@pytest.mark.parametrize("shape,n_labels", [((21, 26), 3), ((30, 40), 2), ((7, 5), 4), ((1, 9), 2)])
def test_connected_components_matches(shape, n_labels):
    labels = np.random.default_rng(6).integers(0, n_labels, shape).astype(np.int32)
    comp_j = np.asarray(jax.jit(jsg.connected_components)(jnp.asarray(labels)))
    comp_t = tsg.connected_components(_t(labels)).numpy()
    np.testing.assert_array_equal(comp_t, comp_j)
    assert len(np.unique(comp_j)) > n_labels  # components, not just labels


def test_crf_mean_field_matches():
    rng = np.random.default_rng(7)
    K, L = 300, 3
    unary = rng.uniform(0, 5, (L, K)).astype(np.float32)
    fs = rng.uniform(0, 10, (K, 2)).astype(np.float32)
    fa = rng.uniform(0, 5, (K, 6)).astype(np.float32)
    q_j = jax.jit(jsg.crf_mean_field, static_argnums=5)(
        jnp.asarray(unary), jnp.asarray(fs), jnp.asarray(fa), 2.0, 7.0, 10
    )
    q_t = tsg.crf_mean_field(_t(unary), _t(fs), _t(fa), 2.0, 7.0, 10)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=5e-5)
    np.testing.assert_array_equal(q_t.argmax(0).numpy(), np.asarray(q_j).argmax(0))


def test_gt_mask_stats_matches(frame):
    depth = np.asarray(frame["depth"])
    mask = frame["mask"].astype(np.int32)
    mask[:10] = 7  # ids outside the slot range are dropped
    for m_j, m_t in zip(jsg.gt_mask_stats(jnp.asarray(mask), jnp.asarray(depth), 3),
                        tsg.gt_mask_stats(_t(mask), _t(depth), 3)):
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("allow_new", [True, False])
@pytest.mark.parametrize("n_active", [2, 1])
def test_perform_segmentation_crf_matches(frame, small_cam, allow_new, n_active):
    """A seeded error surface: model 0 misfits a box region that no active
    model explains, so a new label appears there when allowed — in slot 2
    beside an active object model, or in slot 1 with the background
    alone."""
    jc, tc = _cfgs(small_cam, 6)
    H, W = small_cam.shape
    rng = np.random.default_rng(8)
    err = rng.uniform(0.0, 0.004, (3, H, W)).astype(np.float32)
    err[0, 40:90, 30:80] += 0.3
    err[1] += 0.3
    err[1, 10:40, 100:150] = 0.001
    err[0, 10:40, 100:150] += 0.3
    conf = rng.uniform(0.5, 1.5, (3, H, W)).astype(np.float32)
    active = np.arange(3) < n_active
    nxt = n_active
    args_j = (jnp.asarray(frame["rgb"], jnp.float32), jnp.asarray(frame["depth"]), jnp.asarray(err),
              jnp.asarray(conf), jnp.asarray(active), jnp.int32(nxt), jnp.bool_(allow_new))
    res_j = jax.jit(jsg.perform_segmentation_crf, static_argnums=(7, 8, 9))(
        *args_j, small_cam, jc, SegmentationParams()
    )
    res_t = tsg.perform_segmentation_crf(
        _t(np.asarray(frame["rgb"], np.float32)), _t(frame["depth"]), _t(err), _t(conf),
        _t(active), torch.tensor(nxt, dtype=torch.int32), torch.tensor(allow_new),
        tc.camera, tc, tcfg.SegmentationParams(),
    )
    for name in ("full_segmentation", "has_new_label", "superpixel_count", "bbox"):
        np.testing.assert_array_equal(
            getattr(res_t, name).numpy(), np.asarray(getattr(res_j, name)), err_msg=name
        )
    for name in ("depth_mean", "depth_std", "avg_conf"):
        np.testing.assert_allclose(
            getattr(res_t, name).numpy(), np.asarray(getattr(res_j, name)), rtol=RTOL, atol=ATOL,
            err_msg=name,
        )
    labels = set(np.unique(np.asarray(res_j.full_segmentation)).tolist())
    assert 0 in labels and (nxt in labels) == allow_new, labels
    if n_active == 2:
        assert 1 in labels, labels


def test_gt_mask_mapper_matches():
    """The host remap over a sequence with ids appearing, vanishing (slot
    purged and reused) and a full slot pool."""
    rng = np.random.default_rng(9)
    seq = []
    for i in range(8):
        m = np.zeros((12, 16), np.uint8)
        for vid, lo, hi in ((5, 0, 6), (9, 2, 8), (200, 4, 8), (17, 5, 8)):
            if lo <= i < hi:
                r, c = rng.integers(0, 8), rng.integers(0, 10)
                m[r:r + 4, c:c + 6] = vid
        seq.append(m)
    jm, tm = jsg.GtMaskMapper(), tsg.GtMaskMapper()
    used = {0}
    for i, m in enumerate(seq):
        free = [s for s in range(1, 3) if s not in used]
        out_j, new_j = jm.remap(m, free, allow_new=i % 3 != 2)
        out_t, new_t = tm.remap(m, free, allow_new=i % 3 != 2)
        np.testing.assert_array_equal(out_t, out_j)
        assert new_t == new_j and tm.mapping == jm.mapping
        if new_j is not None:
            used.add(new_j)
        for s in sorted(used - {0}):
            if s not in np.unique(out_j):
                used.discard(s)
                jm.purge_slot(s)
                tm.purge_slot(s)
                assert tm.mapping == jm.mapping


# --- an odd superpixel size (ROADMAP C4): the JAX package asserts S % 2 == 0


def _sums_bincount(chans, w, assign, K, stride=2):
    """The strided per-superpixel sums as numpy float64 bincounts."""
    a = np.asarray(assign)[::stride, ::stride].reshape(-1)
    ws = np.asarray(w, np.float64)[::stride, ::stride].reshape(-1)
    sums = [np.bincount(a, weights=np.asarray(c, np.float64)[::stride, ::stride].reshape(-1) * ws,
                        minlength=K)[:K] for c in chans]
    return sums, np.bincount(a, weights=ws, minlength=K)[:K]


@pytest.mark.parametrize("S", [5, 7, 9])
def test_sp_sums_local_odd_size_matches_bincount(frame, small_cam, S):
    """Where the stride does not divide S, `_sp_sums_local` sums the
    same strided pixels by `_segment_sum`: equal to numpy's bincount of
    them to fp32 rounding, on SLIC's own assignment of the frame."""
    _, tc = _cfgs(small_cam, S)
    rgb = _t(frame["rgb"]).to(torch.float32)
    assign = tsg.slic_assign(rgb, tc)
    H, W = assign.shape
    GH, GW = H // S, W // S
    rng = np.random.default_rng(S)
    w = rng.random((H, W)).astype(np.float32)
    chans = [rgb[..., 0], _t(frame["depth"])]
    sums, cnt = tsg._sp_sums_local(chans, _t(w), assign, GH, GW, S, stride=2)
    want, want_cnt = _sums_bincount([c.numpy() for c in chans], w, assign.numpy(), GH * GW)
    np.testing.assert_allclose(cnt.numpy(), want_cnt, rtol=RTOL, atol=1e-4)
    for got, ref in zip(sums, want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-3)
    assert cnt.sum() > 0.9 * w[::2, ::2].sum()


def test_odd_superpixel_size_segments(frame, small_cam):
    """An odd superpixel size runs the whole CRF segmentation (the JAX
    package stops at its assertion): a moving region in the ICP error of
    the global model wins a new label, as at the default even size."""
    _, tc = _cfgs(small_cam, 7)
    H, W = small_cam.height, small_cam.width
    err = torch.zeros((3, H, W))
    err[0, H // 4: 3 * H // 4, W // 4: 3 * W // 4] = 0.5
    seg = tsg.perform_segmentation_crf(
        _t(frame["rgb"]).to(torch.float32), _t(frame["depth"]), err, torch.ones((3, H, W)),
        torch.tensor([True, False, False]), torch.tensor(1, dtype=torch.int32), torch.tensor(True),
        tc.camera, tc, tcfg.SegmentationParams(),
    )
    assert bool(seg.has_new_label)
    labels = set(seg.full_segmentation.unique().tolist())
    assert labels == {0, 1}
