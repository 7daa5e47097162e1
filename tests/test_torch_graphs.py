"""The step stages' CUDA graph cache (`graphs.StepGraphs`), for every stage
it holds: tracking (`odometry.track_models`) and each slot's fuse/clean
pass (`engine._fuse_clean_all`).  What each stage hands the cache (its key,
its inputs, bit-equality of its graphs) is tested in
test_torch_graphed_tracking.py and test_torch_graphed_fuse.py.

On the CPU: calls through an engine's cache run eagerly and count as such,
fuse/clean passes on a sharded store too; two engines count their own
calls; the least recently used family is evicted past the bound, whatever
its stage; one set of inputs under two stage names gives two keys.

On the card only (skipped here; the fixture decides, so every machine
collects the same tests), at 640x480: new settings of both stages push
every graph out of the cache; the first capture after that, tracking's or
fuse/clean's, takes a new memory pool, and the graphed engine stays bit
for bit equal to an eager twin throughout.  This file imports no JAX, so
on the card it runs without the suite's conftest:

    python3 -m pytest -q --noconftest tests/test_torch_graphs.py \\
        tests/test_torch_graphed_tracking.py tests/test_torch_graphed_fuse.py
"""

import pytest
import torch
import torch.utils._pytree as pytree

from cofusion_tpu_torch import graphs
from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams, TrackingParams
from cofusion_tpu_torch.engine import CoFusion
from cofusion_tpu_torch.graphs import StepGraphs
from cofusion_tpu_torch.io.synthetic import make_sequence
from cofusion_tpu_torch.ops import odometry as od
from cofusion_tpu_torch.ops import preprocess as pp
from cofusion_tpu_torch.parallel import make_mesh, shard_engine_state
from torch_graphs_shared import card, diff, pair  # noqa: F401  (card: a fixture)

SMALL = CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
TINY = CameraConfig(width=64, height=48, fx=52.8, fy=52.8, cx=32.0, cy=24.0)
STAGES = {"tracking": "tracking_graph", "fuse_clean": "fuse_graph"}  # stage -> stats() name


def _track_args(cam=SMALL):
    """One orbit frame tracked against the map of the first: (frame,
    model, so3 reference), the model with no model axis."""
    frames, _, _ = make_sequence(cam, 3, kind="orbit")
    cfg = CoFusionConfig(camera=cam, max_models=1, max_surfels=1 << 12)
    inten = [pp.rgb_to_intensity(torch.from_numpy(f["rgb"]).to(torch.float32)) for f in frames]
    depth = [torch.from_numpy(f["depth"]) for f in frames]
    frame = od.build_frame_pyramid(depth[2], inten[2], cam, cfg, 4.5)
    vm, va = pp.compute_vmap(depth[0], cam, 4.5)
    nm, na = pp.compute_nmap(vm, va)
    model = od.build_model_pyramid(vm, nm, va & na, inten[0], torch.eye(4), cam, cfg)
    return cfg, frame, model, pp.pyr_down_gauss(pp.pyr_down_gauss(inten[0]))


@pytest.mark.parametrize("caller", ["track_models", "get_incremental_transformation"])
def test_cpu_tracking_call_runs_eager(caller):
    cfg, frame, model, so3_ref = _track_args()
    args = (torch.eye(4)[None], frame, tuple(v[None] for v in frame.valid),
            tuple(v[None] for v in frame.rgb_ok),
            od.ModelPyramid(*(tuple(lv[None] for lv in field) for field in model)), so3_ref)
    cache = StepGraphs(1)
    if caller == "track_models":
        res = od.track_models(*args, SMALL, cfg, TrackingParams(), graphs=cache)
    else:
        res = od.get_incremental_transformation(torch.eye(4), frame, model, so3_ref, SMALL, cfg,
                                                TrackingParams(), graphs=cache)
        res = od.OdometryResult(*(t[None] for t in res))
    assert cache.counts("tracking") == dict(captures=0, replays=0, eager=1, evictions=0)
    ref = od.track_models(*args, SMALL, cfg, TrackingParams())
    for name, a, b in zip(od.OdometryResult._fields, res, ref):
        assert torch.equal(a, b), name
    assert res.icp_count[0] > 0


@pytest.mark.parametrize("layout", ["cpu", "sharded"])
def test_cpu_and_sharded_fuse_calls_run_eager(layout):
    frames, _, _ = make_sequence(TINY, 3, kind="orbit")
    cfg = CoFusionConfig(camera=TINY, max_models=1, max_surfels=1 << 12, active_surfels=1 << 11)
    eng = CoFusion(cfg, fusion_params=FusionParams(depth_cutoff=4.5), device="cpu")
    eng.process_frame(frames[0])
    if layout == "sharded":
        eng.state = shard_engine_state(eng.state, make_mesh(2, "cpu"))
    for f in frames[1:]:
        eng.process_frame(f)
    # frame 1 initialises the map: no fuse/clean pass
    assert eng.stats()["fuse_graph"] == dict(captures=0, replays=0, eager=2, evictions=0)


@pytest.mark.parametrize("stage", list(STAGES))
def test_engines_count_their_own_calls(stage):
    cfg = CoFusionConfig(camera=SMALL, max_models=1, max_surfels=1 << 14, active_surfels=1 << 13)
    frames, _, _ = make_sequence(SMALL, 3, kind="orbit")
    a, b = (CoFusion(cfg, fusion_params=FusionParams(depth_cutoff=4.5), device="cpu")
            for _ in range(2))
    for f in frames:
        a.process_frame(f)
    b.process_frame(frames[0])
    b.process_frame(frames[1])
    # frame 1 initialises the map: no tracking, no fuse/clean pass
    assert a.stats()[STAGES[stage]] == dict(captures=0, replays=0, eager=2, evictions=0)
    assert b.stats()[STAGES[stage]] == dict(captures=0, replays=0, eager=1, evictions=0)
    assert a.graphs is not b.graphs


@pytest.mark.parametrize("stage", list(STAGES))
def test_lru_bound_evicts_and_counts(stage):
    cache = StepGraphs(2)
    assert cache.held == 10  # 2 x (2 slots + 3 tracking keys)
    other = next(s for s in STAGES if s != stage)
    keys = [(stage, k) for k in range(cache.held + 2)]
    for k in keys:
        assert cache.family(k) is None
        cache.admit(k, ())
    assert list(cache._families) == keys[2:]
    assert cache.family(keys[2]) is not None and list(cache._families)[-1] == keys[2]
    assert cache.counts(stage) == dict(captures=0, replays=0, eager=0, evictions=2)
    # one bound for every stage: the other stage's new families push these out
    for k in range(3):
        cache.admit((other, k), ())
    assert list(cache._families)[:2] == [keys[6], keys[7]]
    assert cache.counts(stage)["evictions"] == 5
    assert cache.counts(other) == dict(captures=0, replays=0, eager=0, evictions=0)


def test_key_tells_stages_apart():
    x = (torch.zeros((4, 4)), None, 4.5)
    leaves, spec = pytree.tree_flatten(x)
    statics = (SMALL, CoFusionConfig(camera=SMALL))
    tracking, fuse = (graphs.key(stage, leaves, spec, statics) for stage in STAGES)
    assert tracking != fuse
    assert tracking == graphs.key("tracking", leaves, spec, statics)


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.parametrize("first", list(STAGES))
def test_capture_after_every_graph_evicted(card, first):
    """Frames 5-8 change both the ICP weight and the outlier coefficient:
    each admits a new tracking and a new fuse/clean family, eagerly, and
    the 2 x (1 + 3) = 8 held push out the two captured ones.  At frame 9
    only the other stage's setting changes again, so `first`'s family of
    frame 8 is the first to capture with no graph held: it takes a new pool
    (the allocator has released the one no graph holds)."""
    frames, _, _ = make_sequence(CameraConfig(), 12, kind="orbit")
    graphed, eager = pair(card, dict(cfg=CoFusionConfig(camera=CameraConfig(), max_models=1,
                                                        max_surfels=1 << 20),
                                     fusion_params=FusionParams(depth_cutoff=4.5)))
    assert graphed.graphs.held == 8
    pool = None
    for i, f in enumerate(frames):
        if 5 <= i <= 9:
            change = {}
            if i < 9 or first == "fuse_clean":
                change["icp_weight"] = 10.0 - i
            if i < 9 or first == "tracking":
                change["outlier_coefficient"] = 3.0 - 0.25 * (i - 4)
            for e in (graphed, eager):
                e.set_params(**change)
        graphed.process_frame(f)
        eager.process_frame(f)
        assert diff(graphed, eager) == [], f"frame {i}"
        if i == 4:
            pool = graphed.graphs._pool
        if i == 8:
            assert not any(fam.graphs for fam in graphed.graphs._families.values())
            assert graphed.graphs._pool == pool
    assert graphed.graphs._pool != pool
    # tracking: frames 1 and 5-8 eager, 2 captures, replays at 2-4 and 9-11
    # (10-11 when its family of frame 9 is new); fuse/clean: 1 and 5-8
    # eager, 2 captures a family, replays at 2-4 and 9-11 (10-11 likewise)
    tracking_first = first == "tracking"
    assert graphed.graphs.counts("tracking") == dict(
        captures=2, replays=6 if tracking_first else 5, eager=5 if tracking_first else 6,
        evictions=2)
    assert graphed.graphs.counts("fuse_clean") == dict(
        captures=4, replays=5 if tracking_first else 6, eager=6 if tracking_first else 5,
        evictions=1)
