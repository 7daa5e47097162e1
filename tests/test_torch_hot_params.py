"""Hot tuning of the port's engine (`set_params`, `set_confidence_threshold`)
against the JAX package's, the counterpart of tests/test_hot_params.py: the
same calls between the same frames of both engines keep the runs within
the pose bar; every hot name reaches the step (the CRF's over the engine's
SegmentationParams); unknown names raise.  Also the continuation of a JAX
state carried across by convert.py (the route from a JAX run into the
port: the JAX package's checkpoints pickle its own classes).

Bars: per-frame camera poses within 1e-5 + 2e-6*step (the fp32
reduction-order bound of tests/test_torch_engine.py), surfel counts exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import cofusion_tpu_torch.engine as engine_mod
from cofusion_tpu.config import CameraConfig, CoFusionConfig, FusionParams
from cofusion_tpu.engine import CoFusion as JaxCoFusion
from cofusion_tpu.io.synthetic import make_sequence
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch import convert
from cofusion_tpu_torch.engine import CoFusion

torch.set_num_threads(1)
TINY = CameraConfig(width=80, height=64, fx=66.0, fy=66.0, cx=40.0, cy=32.0)
N, HOT = 6, 3  # frames; the calls come before frame HOT
FUSION = dict(depth_cutoff=4.5, confidence_global=1.5)
CALLS = dict(depth_cutoff=3.0, icp_weight=25.0, outlier_coefficient=5.0)


def _pose_bar(step):
    return 1e-5 + 2e-6 * step


def _port(multi=False, **kw):
    cfg = tcfg.CoFusionConfig(camera=tcfg.CameraConfig(**dataclasses.asdict(TINY)),
                              max_models=3 if multi else 1, max_surfels=1 << 13)
    return CoFusion(cfg, fusion_params=tcfg.FusionParams(**FUSION), enable_multi_model=multi,
                    device="cpu", **kw)


def _tune(eng):
    eng.set_params(**CALLS)
    eng.set_confidence_threshold(0, 2.5)


def _play(eng, frames, tune_at=HOT, start=0):
    """Per-frame (pose of slot 0, surfel count) from frame `start` on."""
    out = []
    for i in range(start, len(frames)):
        if i == tune_at:
            _tune(eng)
        eng.process_frame(frames[i])
        st = eng.stats()
        out.append((st["poses"][0], int(st["surfel_counts"][0])))
    return out


def test_set_params_mid_run_matches_jax():
    """set_params(depth_cutoff, icp_weight, outlier_coefficient) and
    set_confidence_threshold(0, 2.5) before frame 3 of the static path, in
    both engines: every frame within the bar, counts exact, and the run
    parts from an untouched one from that frame on.  A port engine that
    takes JAX's state before the calls (convert.py) and gets the same calls
    continues within the bar too."""
    frames, _, _ = make_sequence(TINY, N, kind="orbit")
    jeng = JaxCoFusion(CoFusionConfig(camera=TINY, max_models=1, max_surfels=1 << 13),
                       fusion_params=FusionParams(**FUSION))
    ref, before_calls = [], None
    for i, f in enumerate(frames):
        if i == HOT:
            before_calls = jax.tree.map(np.array, jeng.state)
            _tune(jeng)
        jeng.process_frame(f)
        st = jeng.stats()
        ref.append((st["poses"][0], int(st["surfel_counts"][0])))
    assert float(np.asarray(jeng.state.models.conf_threshold)[0]) == 2.5

    tuned = _play(_port(), frames)
    untouched = _play(_port(), frames, tune_at=None)
    resumed = _port()
    resumed.state = convert.state_from_numpy(before_calls)
    resumed._timestamps = [f["timestamp"] for f in frames[:HOT]]
    continued = _play(resumed, frames, start=HOT)
    for step, ((p, c), (jp, jc)) in enumerate(zip(tuned, ref)):
        assert c == jc, step
        np.testing.assert_allclose(p, jp, atol=_pose_bar(step), err_msg=f"frame {step}")
    for step, ((p, c), (jp, jc)) in enumerate(zip(continued, ref[HOT:]), start=HOT):
        assert c == jc, step
        np.testing.assert_allclose(p, jp, atol=_pose_bar(step), err_msg=f"resumed frame {step}")
    parted = [i for i, ((p, c), (q, d)) in enumerate(zip(tuned, untouched))
              if c != d or not np.array_equal(p, q)]
    assert parted == list(range(HOT, N))
    assert float(resumed.state.models.conf_threshold[0]) == 2.5


def test_set_params_rejects_unknown():
    """Both engines take the same names and refuse others with ValueError."""
    jeng = JaxCoFusion(CoFusionConfig(camera=TINY, max_models=1))
    assert CoFusion._HOT_PARAMS == JaxCoFusion._HOT_PARAMS
    for eng in (jeng, _port()):
        with pytest.raises(ValueError, match="not hot-tunable"):
            eng.set_params(not_a_param=1.0)
        with pytest.raises(ValueError, match="not hot-tunable"):
            eng.set_params(icp_weight=1.0, time_delta=3)


def _captured_calls(monkeypatch, name):
    calls = []
    fn = getattr(engine_mod, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    monkeypatch.setattr(engine_mod, name, spy)
    return calls


@pytest.mark.parametrize("name", sorted(CoFusion._HOT_CRF))
def test_hot_crf_scalar_reaches_segmentation(monkeypatch, name):
    """A CRF scalar set between frames reaches the next frame's
    segmentation over the engine's own SegmentationParams (which the CLI
    sets), and leaves those as they were."""
    calls = _captured_calls(monkeypatch, "_step")
    eng = _port(multi=True)
    eng.segmentation = dataclasses.replace(eng.segmentation, crf_iterations=3)
    frames, _, _ = make_sequence(TINY, 3, kind="orbit")
    frames = [dict(f, mask=None) for f in frames]  # no masks: the CRF path
    eng.process_frame(frames[0])
    eng.process_frame(frames[1])
    eng.set_params(**{name: 0.125})
    eng.process_frame(frames[2])
    field = CoFusion._HOT_CRF[name]
    first, last = calls[0][1]["sparams"], calls[-1][1]["sparams"]
    assert getattr(first, field) != 0.125 and getattr(last, field) == 0.125
    assert last.crf_iterations == 3 and calls[-1][1]["use_crf"]
    assert last == dataclasses.replace(eng.segmentation, **{field: 0.125})
    assert getattr(eng.segmentation, field) == getattr(first, field)


@pytest.mark.parametrize("name", sorted(CoFusion._HOT_FPARAMS))
def test_hot_scalar_reaches_step(monkeypatch, name):
    """Every other hot name is a Python number of the next frame's step
    scalars (no device copy, no rebuild)."""
    calls = _captured_calls(monkeypatch, "_step")
    eng = _port()
    frames, _, _ = make_sequence(TINY, 3, kind="orbit")
    eng.process_frame(frames[0])
    eng.process_frame(frames[1])
    eng.set_params(**{name: 0.75})
    eng.process_frame(frames[2])
    key = CoFusion._HOT_FPARAMS[name]
    before, after = calls[0][0][4], calls[-1][0][4]
    assert before[key] != 0.75 and after[key] == 0.75 and type(after[key]) is float


def test_set_confidence_threshold_before_first_frame():
    """Before the first frame the call sets the threshold the run starts
    with, as the JAX engine does: slot 0 the global one, any other slot the
    object one (also what a recycled slot is reset to)."""
    jeng = JaxCoFusion(CoFusionConfig(camera=TINY, max_models=3), enable_multi_model=True)
    eng = _port(multi=True)
    for e in (jeng, eng):
        e.set_confidence_threshold(0, 4.0)
        e.set_confidence_threshold(2, 0.25)
    for field in ("confidence_global", "confidence_object"):
        assert getattr(eng.fusion, field) == getattr(jeng.fusion, field)
    assert eng._fparams["conf_object"] == 0.25
    frames, _, _ = make_sequence(TINY, 1, kind="orbit")
    eng.process_frame(frames[0])
    assert eng.state.models.conf_threshold.tolist() == [4.0, 0.25, 0.25]


def test_set_confidence_threshold_between_frames():
    """Between frames the call writes one slot's threshold on the device as
    a new tensor (a held state keeps its values), the value rounded to fp32
    as JAX rounds it."""
    eng = _port(multi=True)
    frames, _, _ = make_sequence(TINY, 2, kind="orbit")
    eng.process_frame(frames[0])
    held = eng.state
    before = held.models.conf_threshold.clone()
    eng.set_confidence_threshold(1, 0.1)
    assert torch.equal(held.models.conf_threshold, before)
    got = eng.state.models.conf_threshold
    assert got.dtype == torch.float32
    assert got[1].item() == np.float32(0.1) and torch.equal(got[[0, 2]], before[[0, 2]])
    eng.process_frame(frames[1])
