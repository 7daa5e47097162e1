"""The port's checkpoints (cofusion_tpu_torch/utils/checkpoint.py), the
counterpart of tests/test_checkpoint.py: a run saved mid-sequence and
resumed in a new engine continues bit for bit (static, and the GT-mask
path with 3 slots); the file is a plain dict of tensors that
`torch.load(weights_only=True)` reads on any device; loading clamps object
slots to their active slice (ROADMAP C2); the CLI's -checkpoint/-resume.

A checkpoint of the JAX package pickles its classes and is not read by the
port: a JAX state crosses through convert.py, whose continuation within the
pose bar is held in tests/test_torch_hot_params.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cofusion_tpu.config import CameraConfig
from cofusion_tpu.io.readers import write_klg
from cofusion_tpu.io.synthetic import make_sequence
from cofusion_tpu_torch import cli
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch.engine import CoFusion
from cofusion_tpu_torch.models import surfel_model as sm
from cofusion_tpu_torch.utils import checkpoint as ckpt
from cofusion_tpu_torch.utils import export as texport

torch.set_num_threads(1)
TINY = CameraConfig(width=80, height=64, fx=66.0, fy=66.0, cx=40.0, cy=32.0)
N, K = 6, 4  # frames, and the frame count at the save


def _engine(multi, **cfg_kw):
    kw = dict(max_models=3 if multi else 1, max_surfels=1 << 14, **cfg_kw)
    fusion = dict(depth_cutoff=4.5, confidence_global=1.5)
    if multi:
        fusion.update(confidence_object=0.01, model_spawn_offset=0)
    return CoFusion(tcfg.CoFusionConfig(camera=tcfg.CameraConfig(**dataclasses.asdict(TINY)), **kw),
                    fusion_params=tcfg.FusionParams(**fusion), enable_multi_model=multi,
                    device="cpu")


def _assert_states_equal(a, b):
    fa, fb = ckpt.flatten_state(a), ckpt.flatten_state(b)
    assert fa.keys() == fb.keys()
    for key in fa:
        if isinstance(fa[key], torch.Tensor):
            assert fa[key].dtype == fb[key].dtype and torch.equal(fa[key], fb[key]), key
        else:
            assert fa[key] == fb[key], key


@pytest.mark.parametrize("mode", ["static", "gt_masks_3_slots"])
def test_checkpoint_resume_bit_exact(tmp_path, mode):
    """Save after K frames, resume in a new engine, run both to N: every
    state leaf, the pose log and the slot bookkeeping equal bit for bit."""
    multi = mode != "static"
    frames, _, _ = make_sequence(TINY, N, kind="orbit", moving_object=multi)
    a = _engine(multi)
    for f in frames[:K]:
        a.process_frame(f)
    path = str(tmp_path / "state.ckpt")
    ckpt.save_engine(a, path)
    b = _engine(multi)
    ckpt.load_engine(b, path)
    assert b.state.tick == a.state.tick == K
    _assert_states_equal(b.state, a.state)
    if multi:
        assert b._ever_active == a._ever_active and len(a._ever_active) > 1
        assert b._gt_mapper.mapping == a._gt_mapper.mapping
        assert b._host_cooldown == a._host_cooldown
    for f in frames[K:]:
        for eng in (a, b):
            eng.process_frame(f)
    _assert_states_equal(b.state, a.state)
    la, lb = a.materialized_pose_log(), b.materialized_pose_log()
    assert [t for t, _ in la] == [t for t, _ in lb] == [f["timestamp"] for f in frames]
    for (_, pa), (_, pb) in zip(la, lb):
        np.testing.assert_array_equal(pa, pb)


def test_checkpoint_is_plain_tensors(tmp_path):
    """The file is `torch.save` of {"state": {field path: tensor or the int
    tick}, "timestamps", "version"}: `weights_only=True` loads it, with
    every leaf where `map_location` puts it; views are stored compact."""
    frames, _, _ = make_sequence(TINY, 3, kind="orbit")
    eng = _engine(False)
    for f in frames:
        eng.process_frame(f)
    path = str(tmp_path / "state.ckpt")
    ckpt.save_engine(eng, path)
    blob = torch.load(path, weights_only=True, map_location="cpu")
    assert blob["version"] == ckpt.VERSION
    assert blob["timestamps"] == [f["timestamp"] for f in frames]
    flat = blob["state"]
    assert flat["tick"] == 3
    assert {"models.store.px", "models.stable.count", "models.pose", "pred.image", "fern_db",
            "pose_history", "mask_history"} <= flat.keys()
    for key, value in flat.items():
        if key != "tick":
            assert isinstance(value, torch.Tensor) and value.device.type == "cpu", key
            assert value.untyped_storage().nbytes() == value.numel() * value.element_size(), key
    _assert_states_equal(ckpt.unflatten_state(flat), eng.state)


def test_checkpoint_clamps_object_slices(tmp_path):
    """ROADMAP C2: a state whose object slot holds more active rows than
    `object_active_capacity` (saved with a larger slice) loads with that
    slot's count clamped and the rows past the slice cleared; the global
    slot is untouched."""
    frames, _, _ = make_sequence(TINY, 2, kind="orbit")
    big = _engine(True, expel_block_log2=10)
    for f in frames:
        big.process_frame(f)
    st = big.state
    store = st.models.store
    A = store.px.shape[1]
    small = _engine(True, expel_block_log2=10, object_active_surfels=A // 8)
    cap = small.cfg.object_active_capacity
    assert cap < A // 2
    # slot 1 holds a copy of the global map: more rows than the slice
    n = int(store.count[0])
    assert n > cap
    filled = sm.SurfelStore(
        *(torch.cat([getattr(store, f)[:1], getattr(store, f)[:1], getattr(store, f)[2:]])
          for f in sm.DATA_FIELDS),
        count=torch.tensor([n, n, 0], dtype=torch.int32),
    )
    big.state = st._replace(models=st.models._replace(store=filled))
    path = str(tmp_path / "big.ckpt")
    ckpt.save_engine(big, path)
    ckpt.load_engine(small, path)
    got = small.state.models.store
    assert got.count.tolist() == [n, cap, 0]
    assert not got.valid[1, cap:].any() and got.valid[1, :cap].equal(filled.valid[1, :cap])
    for f in sm.DATA_FIELDS[:-1]:
        leaf = getattr(got, f)
        assert not leaf[1, cap:].any(), f
        assert leaf[1, :cap].equal(getattr(filled, f)[1, :cap]), f
        assert leaf[0].equal(getattr(filled, f)[0]), f
    assert got.valid[0].equal(filled.valid[0])


def test_checkpoint_restores_host_bookkeeping(tmp_path):
    """The host's timestamps and bookkeeping come back, and slots active in
    the saved state count as used and ever active (as the JAX package
    rebuilds them)."""
    frames, _, _ = make_sequence(TINY, 2, kind="orbit")
    eng = _engine(True)
    for f in frames:
        eng.process_frame(f)
    act = eng.state.models.active.clone()
    act[2] = True
    eng.state = eng.state._replace(models=eng.state.models._replace(active=act))
    path = str(tmp_path / "s.ckpt")
    ckpt.save_engine(eng, path)
    fresh = _engine(True)
    ckpt.load_engine(fresh, path)
    assert fresh._timestamps == [f["timestamp"] for f in frames]
    assert fresh._used_slots == {0, 2} and fresh._ever_active == {0, 2}
    np.testing.assert_array_equal(fresh.current_segmentation(), eng.current_segmentation())
    assert fresh.model_ever_active(2) and not fresh.model_ever_active(1)


def test_cli_checkpoint_and_resume(tmp_path):
    """`-checkpoint` after K frames (`-e K`), then `-resume` from frame K
    (`-s K`): the resumed run's pose file equals one run straight through,
    line for line."""
    frames, _, _ = make_sequence(TINY, N, kind="orbit")
    klg = str(tmp_path / "log.klg")
    write_klg(klg, frames, TINY.width, TINY.height)
    cal = tmp_path / "cal.txt"
    cal.write_text(f"{TINY.fx} {TINY.fy} {TINY.cx} {TINY.cy} {TINY.width} {TINY.height}")
    base = ["-l", klg, "-cal", str(cal), "-static", "-d", "4.5", "-confG", "1.5", "-ns", "16384",
            "-ep", "-device", "cpu"]
    path = str(tmp_path / "run.ckpt")
    assert cli.run(base + ["-exportdir", str(tmp_path / "whole")]) == 0
    assert cli.run(base + ["-e", str(K), "-checkpoint", path]) == 0
    assert os.path.getsize(path) > 0
    assert cli.run(base + ["-s", str(K), "-resume", path, "-exportdir", str(tmp_path / "resumed")]) == 0
    whole = (tmp_path / "whole" / "poses-0.txt").read_text().splitlines()
    resumed = (tmp_path / "resumed" / "poses-0.txt").read_text().splitlines()
    assert len(whole) == N and resumed == whole
    ts, _ = texport.load_tum_trajectory(str(tmp_path / "resumed" / "poses-0.txt"))
    np.testing.assert_array_equal(ts, [f["timestamp"] for f in frames])
