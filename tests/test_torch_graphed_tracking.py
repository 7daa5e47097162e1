"""`track_models` as a CUDA graph (the `tracking` stage of
`graphs.StepGraphs`; what the cache does for every stage is in
test_torch_graphs.py).

On the CPU: the cache key tells apart every setting a captured solve
reads, the inputs' structure and the shape of every input field, and
matches equal settings built afresh; the normal equations give each
model its own system.

On the card only (skipped here; the fixture decides, so every machine
collects the same tests), with the inputs the engine hands `track_models`
at 640x480, one model (the static cells') and four with GT-mask gates (the
multi-model cells', every slot tracking the global model's map): graphed
against eager bit for bit over consecutive calls with different inputs, a
kept result unchanged by the next replay, a new `icp_weight` recaptured,
and a graph unaffected when `_intrinsics`' cache drops the K it was
handed.
This file imports no JAX, so on the card it runs without the suite's
conftest:

    python3 -m pytest -q --noconftest tests/test_torch_graphed_tracking.py
"""

import dataclasses

import pytest
import torch
import torch.utils._pytree as pytree

from cofusion_tpu_torch import graphs
from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, TrackingParams
from cofusion_tpu_torch.engine import CoFusion
from cofusion_tpu_torch.graphs import StepGraphs
from cofusion_tpu_torch.io.synthetic import make_multi_object_frames, make_sequence
from cofusion_tpu_torch.ops import odometry as od
from cofusion_tpu_torch.ops import preprocess as pp
from torch_graphs_shared import card  # noqa: F401  (a fixture)

SMALL = CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)


def _zeros_inputs(M: int, cam: CameraConfig, levels: int = 3):
    """The solve's tensor inputs at the given sizes, every field a tensor as
    `track_models` hands them to the cache (values unused)."""
    shapes = [(cam.at_level(lv).height, cam.at_level(lv).width) for lv in range(levels)]

    def per_level(tail=(), lead=(), dtype=torch.float32, flat=False):
        return tuple(torch.zeros(lead + ((h * w,) if flat else (h, w)) + tail, dtype=dtype)
                     for h, w in shapes)

    frame = od.FramePyramid(
        vmap=per_level((3,)), nmap=per_level((3,)), valid=per_level(dtype=torch.bool),
        depth=per_level(), intensity=per_level(), didx=per_level(), didy=per_level(),
        rgb_ok=per_level(dtype=torch.bool),
    )
    model = od.ModelPyramid(
        vmap_w=per_level((3,), (M,)), nmap_w=per_level((3,), (M,)),
        valid=per_level(lead=(M,), dtype=torch.bool), depth=per_level(lead=(M,)),
        intensity=per_level(lead=(M,)), icp_pack=per_level((8,), (M,), flat=True),
        rgb_pack=per_level((2,), (M,), flat=True),
    )
    intrinsics = tuple((torch.zeros((3, 3)), torch.zeros((3, 3))) for _ in shapes)
    return (torch.zeros((M, 4, 4)), frame, per_level(lead=(M,), dtype=torch.bool),
            per_level(lead=(M,), dtype=torch.bool), model, torch.zeros(shapes[-1]), intrinsics)


def _key(M=1, cam=SMALL, cfg=None, params=None, w=10.0, inputs=None):
    """As `track_models` keys its solve."""
    cfg = cfg or CoFusionConfig(camera=cam, max_models=M)
    leaves, spec = pytree.tree_flatten(inputs or _zeros_inputs(M, cam))
    return graphs.key("tracking", leaves, spec, (cam, cfg, params or TrackingParams(), w))


# every setting `_solve` and the terms it calls read
_CAM_FIELDS = ["width", "height", "fx", "fy", "cx", "cy"]
_CFG_FIELDS = {"pyramid_levels": 2, "so3_iters": 4, "gn_iters": (10, 5, 3), "fast_odom": True,
               "use_so3": False, "use_pyramid": False, "gn_stride_l0": 1, "gn_stride_l1": 2}
_PARAM_FIELDS = {"icp_weight": 4.0, "dist_thresh": 0.05, "angle_thresh_sin": 0.5,
                 "max_depth_delta_rgb": 0.1, "sobel_scale": 0.25, "min_grad_mags": (5.0, 3.0, 2.0),
                 "rgb_only": True, "max_translation_jump": 0.2, "min_correspondences": 30.0,
                 "gn_converge_eps": 1e-6, "consistent_icp_weighting": False}


def _with(tree, path, value):
    """`tree` with the field at `path` (names and indices) replaced."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    if isinstance(head, str):
        return tree._replace(**{head: _with(getattr(tree, head), rest, value)})
    return tree[:head] + (_with(tree[head], rest, value),) + tree[head + 1:]


def _changed(change):
    kind, name = change
    base = _zeros_inputs(1, SMALL)
    if kind == "cam":
        cam = dataclasses.replace(SMALL, **{name: getattr(SMALL, name) + 16})
        return _key(cam=cam, cfg=CoFusionConfig(camera=SMALL, max_models=1), inputs=base)
    if kind == "cfg":
        return _key(cfg=CoFusionConfig(camera=SMALL, max_models=1, **{name: _CFG_FIELDS[name]}))
    if kind == "params":
        return _key(params=TrackingParams(**{name: _PARAM_FIELDS[name]}))
    if name == "icp_weight":
        return _key(w=5.0)
    if name == "M":
        return _key(M=4, cfg=CoFusionConfig(camera=SMALL, max_models=1))
    if name == "dtype":
        return _key(inputs=(base[0].double(),) + base[1:])
    if name == "stride":  # the finest valid gate, stored column-major
        v = base[2][0]
        return _key(inputs=_with(base, (2, 0), v.transpose(1, 2).contiguous().transpose(1, 2)))
    if name == "none_field":
        return _key(inputs=_with(base, (4, "vmap_w"), None))
    raise AssertionError(change)


@pytest.mark.parametrize(
    "change",
    [("cam", f) for f in _CAM_FIELDS] + [("cfg", f) for f in _CFG_FIELDS]
    + [("params", f) for f in _PARAM_FIELDS]
    + [("call", n) for n in ("icp_weight", "M", "dtype", "stride", "none_field")],
    ids=lambda c: ".".join(c),
)
def test_graph_key_tells_apart(change):
    assert _changed(change) != _key()


def test_graph_key_tells_apart_tf32(monkeypatch):
    base = _key()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        not torch.backends.cuda.matmul.allow_tf32)
    assert _key() != base


# every tensor field of the solve's inputs, by path
_INPUT_FIELDS = ([("poses",), ("so3_ref",), ("valid_b",), ("rgb_ok_b",), ("intrinsics",)]
                 + [("frame", f) for f in od.FramePyramid._fields]
                 + [("model_b", f) for f in od.ModelPyramid._fields])
_ARG = {"poses": 0, "frame": 1, "valid_b": 2, "rgb_ok_b": 3, "model_b": 4, "so3_ref": 5,
        "intrinsics": 6}


@pytest.mark.parametrize("field", _INPUT_FIELDS, ids=".".join)
def test_graph_key_reads_every_input_field(field):
    """One rule takes in every tensor field: a field whose size changes
    changes the key, whether the solve reads it or not."""
    base = _zeros_inputs(1, SMALL)
    path = (_ARG[field[0]],) + field[1:]
    t = base[path[0]] if len(path) == 1 else getattr(base[path[0]], path[1])
    while isinstance(t, tuple):  # per level (K, K^-1 a pair): the finest one grows a row
        path, t = path + (0,), t[0]
    grown = torch.cat([t, t[:1]])
    assert _key(inputs=_with(base, path, grown)) != _key(inputs=base)


@pytest.mark.parametrize("caller", ["engine", "relocalise", "local_loop"])
def test_graph_key_equal_for_settings_built_afresh(caller):
    """As the engine, `_relocalise` and `local_loop` rebuild their settings
    on every frame."""
    def settings():
        cfg, tp = CoFusionConfig(camera=SMALL), TrackingParams()
        if caller == "relocalise":
            cfg = cfg.replace(use_so3=False, use_pyramid=False, gn_iters=(20, 0, 0), gn_stride_l0=1)
            tp = TrackingParams(icp_weight=100.0, min_correspondences=20.0)
        elif caller == "local_loop":
            cfg = cfg.replace(use_so3=False, gn_stride_l0=1)
        return cfg, tp

    (c1, p1), (c2, p2) = settings(), settings()
    assert c1 is not c2 and p1 is not p2
    assert _key(cfg=c1, params=p1, w=p1.icp_weight) == _key(cfg=c2, params=p2, w=p2.icp_weight)
    assert hash(_key(cfg=c1, params=p1)) == hash(_key(cfg=c2, params=p2))


@pytest.mark.parametrize("M", [1, 4])
def test_normal_equations_are_each_models_own(M):
    """`_reduce_system_b`: each model's system is its own rows'
    (7xP)@(Px7), untouched by the other models."""
    gen = torch.Generator().manual_seed(M)
    rows = torch.randn((M, 12, 10, 7), generator=gen, dtype=torch.float64)
    found = torch.rand((M, 12, 10), generator=gen) < 0.6
    A, b, err, count = od._reduce_system_b(rows, found)
    for m in range(M):
        f = torch.where(found[m, ..., None], rows[m], 0.0).reshape(-1, 7)
        own = f.T @ f
        torch.testing.assert_close(A[m], own[:6, :6], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(b[m], own[:6, 6], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(err[m], own[6, 6], rtol=1e-12, atol=1e-12)
        assert count[m] == found[m].sum()


# ---------------------------------------------------------------------------
# on the card


def _record(engine: CoFusion, frames) -> list:
    """Every `track_models` call the engine makes over `frames`, its
    tensors cloned: (inputs, (cam, cfg, params, icp_weight))."""
    calls = []
    track = od.track_models

    def spy(poses, frame, valid_b, rgb_ok_b, model_b, so3, cam, cfg, params, icp_weight=None,
            graphs=None):
        def cl(x):
            return None if x is None else tuple(t.clone() for t in x)

        calls.append(((poses.clone(), type(frame)(*map(cl, frame)), cl(valid_b), cl(rgb_ok_b),
                       type(model_b)(*map(cl, model_b)), so3.clone()),
                      (cam, cfg, params, params.icp_weight if icp_weight is None else icp_weight)))
        return track(poses, frame, valid_b, rgb_ok_b, model_b, so3, cam, cfg, params, icp_weight,
                     graphs=graphs)

    od.track_models = spy
    try:
        for f in frames:
            engine.process_frame(f)
        torch.cuda.synchronize()
    finally:
        od.track_models = track
    return calls


@pytest.fixture(scope="module", params=["static_m1", "gtmask_m4"])
def calls(request, card):
    """Consecutive frames' `track_models` calls at 640x480."""
    cam = CameraConfig()
    if request.param == "static_m1":
        frames, _, _ = make_sequence(cam, 7, kind="orbit")
        eng = CoFusion(CoFusionConfig(camera=cam, max_models=1, max_surfels=1 << 20), device=card)
    else:
        frames = make_multi_object_frames(cam, 7, masks=True)
        eng = CoFusion(CoFusionConfig(camera=cam, max_models=4, max_surfels=1 << 20),
                       enable_multi_model=True, device=card)
    out = _record(eng, frames)
    assert len(out) >= 5
    if request.param == "gtmask_m4":
        out = [(_objects_see_the_map(inputs), statics) for inputs, statics in out]
    return out


def _objects_see_the_map(inputs):
    """Slots 1-3 hold no map and no mask pixels in six frames (they have not
    spawned), so their solves would be empty: give every slot the global
    model's prediction, at the camera pose moved by m mm, and gate slot m to
    the m-th quarter of the image's columns with the engine's mask gates."""
    poses, frame, _, _, model_b, so3 = inputs
    M, dev = poses.shape[0], poses.device
    poses = poses[:1].repeat(M, 1, 1)
    poses[:, 0, 3] += torch.arange(M, device=dev) * 1e-3
    model_b = od.ModelPyramid(*(tuple(t[:1].expand_as(t).clone() for t in f) for f in model_b))
    H, W = frame.depth[0].shape
    mask_pyrs = [(torch.arange(W, device=dev, dtype=torch.int32) * M // W).expand(H, W).contiguous()]
    for _ in range(len(frame.depth) - 1):
        mask_pyrs.append(pp.pyr_down_nearest(mask_pyrs[-1]))
    valid_b, rgb_ok_b = od.masked_validity_b(frame, mask_pyrs, od.mask_window_bounds(mask_pyrs),
                                             torch.arange(M, device=dev, dtype=torch.int32))
    return poses, frame, valid_b, rgb_ok_b, model_b, so3


def _equal(a: od.OdometryResult, b: od.OdometryResult) -> list:
    return [n for n, x, y in zip(od.OdometryResult._fields, a, b) if not torch.equal(x, y)]


def _graphed(cache: StepGraphs, inputs, statics) -> od.OdometryResult:
    return od.track_models(*inputs, *statics, graphs=cache)


def _eager(inputs, statics) -> od.OdometryResult:
    return od.track_models(*inputs, *statics)


def test_graphed_bit_equal_to_eager(calls):
    cache = StepGraphs(1)
    for k, (inputs, statics) in enumerate(calls):
        assert _equal(_graphed(cache, inputs, statics), _eager(inputs, statics)) == [], f"call {k}"
    assert cache.counts("tracking") == dict(captures=1, replays=len(calls) - 1, eager=1,
                                            evictions=0)
    # the inputs differ from call to call, so a stale copy-in would show
    assert not torch.equal(calls[1][0][1].depth[0], calls[2][0][1].depth[0])


def test_kept_result_survives_next_replay(calls):
    cache = StepGraphs(1)
    _graphed(cache, *calls[0])
    kept = _graphed(cache, *calls[1])
    copy = od.OdometryResult(*(t.clone() for t in kept))
    _graphed(cache, *calls[2])
    assert _equal(kept, copy) == []
    assert _equal(kept, _eager(*calls[1])) == []


def test_new_icp_weight_recaptures(calls):
    cache = StepGraphs(1)
    for inputs, statics in calls[:2]:
        _graphed(cache, inputs, statics)
    for inputs, statics in calls[2:5]:
        statics = statics[:3] + (statics[3] * 0.5,)
        assert _equal(_graphed(cache, inputs, statics), _eager(inputs, statics)) == []
    assert cache.counts("tracking") == dict(captures=2, replays=3, eager=2, evictions=0)
    inputs, statics = calls[0]  # the first weight's graph, still held
    assert _equal(_graphed(cache, inputs, statics), _eager(inputs, statics)) == []
    assert cache.counts("tracking")["replays"] == 4


def test_graph_survives_dropped_intrinsics(calls):
    """The graph reads its own copies of K and K^-1: when `_intrinsics`'
    cache drops the ones it was handed and their memory is handed out
    again, a replay still reads the right ones."""
    cache = StepGraphs(1)
    _graphed(cache, *calls[0])
    _graphed(cache, *calls[1])  # captured
    od._intrinsics.cache_clear()
    junk = [torch.full((3, 3), float("nan"), device=calls[0][0][0].device) for _ in range(64)]
    inputs, statics = calls[2]
    res = _graphed(cache, inputs, statics)
    assert _equal(res, _eager(inputs, statics)) == []
    del junk
