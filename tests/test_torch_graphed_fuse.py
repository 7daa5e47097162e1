"""Each slot's fuse/clean pass as a CUDA graph (the `fuse_clean` stage of
`graphs.StepGraphs`; what the cache does for every stage is in
test_torch_graphs.py).

On the CPU: the pass gives the same bits with the tick as a 0-d float32
tensor as with the Python tick, in both stagger phases and on an object
slot's idle select; the cache key tells apart every setting a captured
pass reads, the inputs' structure and sizes and the address of every store
leaf it reads in place, and matches equal settings built afresh; a step
keeps the addresses of the active tier's leaves (the slots reset and
`-cl`'s slot 0 written back in place).

On the card only (skipped here; the fixture decides, so every machine
collects the same tests), at 640x480: an engine whose slots replay their
graphs against one that runs the same pass eagerly, bit for bit on every
leaf of the state after every frame, for the static mode (one slot), four
slots with GT masks across a spawn, a wipe and a respawn (the idle select
flips both ways) and `-cl` at one slot; the graphed engine's counters; a
downloaded map unchanged by the next replays; a new outlier coefficient
captured anew; a sharded state's passes eager.  This file imports no JAX,
so on the card it runs without the suite's conftest:

    python3 -m pytest -q --noconftest tests/test_torch_graphed_fuse.py
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from cofusion_tpu_torch import engine as te
from cofusion_tpu_torch import graphs
from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams
from cofusion_tpu_torch.engine import CoFusion, SlotInputs
from cofusion_tpu_torch.io.synthetic import make_multi_object_frames, make_sequence
from cofusion_tpu_torch.models import surfel_model as sm
from cofusion_tpu_torch.parallel import make_mesh, shard_engine_state
from torch_graphs_shared import card, diff, pair  # noqa: F401  (card: a fixture)

TINY = CameraConfig(width=64, height=48, fx=52.8, fy=52.8, cx=32.0, cy=24.0)


def _tiny_cfg(M: int, **kw) -> CoFusionConfig:
    return CoFusionConfig(camera=TINY, max_models=M, max_surfels=1 << 12, active_surfels=1 << 11,
                          **kw)


def _gt_fusion(**kw) -> FusionParams:
    """Objects spawn as soon as their ids show, and a map that loses its
    id is wiped (never mature at confO 0.01)."""
    return FusionParams(depth_cutoff=4.5, confidence_object=0.01, model_spawn_offset=0, **kw)


def _gt_frames(cam: CameraConfig, n: int, hide: tuple = (), hidden_id: int = 3):
    """Three moving boxes with their ids as masks (id 2 leaves the view
    after frame 2); at the frames in `hide` `hidden_id` is painted over as
    background, so its slot is wiped and a slot respawns when the id shows
    again."""
    frames = make_multi_object_frames(cam, n, masks=True)
    for i in hide:
        mask = np.asarray(frames[i]["mask"]).copy()
        mask[mask == hidden_id] = 0
        frames[i] = dict(frames[i], mask=mask)
    return frames


# ---------------------------------------------------------------------------
# on the CPU


def _slot_call(M: int):
    """Slot 0's arguments after one fused frame at 64x48: the stacked
    stores, the frame's `SlotInputs` with the tick left to the caller, and
    the settings; at M > 1 with the slot-id mask and the select on the
    active flag, as under '-rl' or for an object slot."""
    m = 0
    frames, _, _ = make_sequence(TINY, 2, kind="orbit")
    cfg = _tiny_cfg(M)
    eng = CoFusion(cfg, fusion_params=FusionParams(depth_cutoff=4.5), device="cpu")
    eng.process_frame(frames[0])
    eng.process_frame(frames[1])
    st = eng.state
    f = frames[1]
    depth = torch.from_numpy(f["depth"])
    multi = M > 1
    x = SlotInputs(
        pose=st.models.pose[m], weight=torch.tensor(0.75),
        model_id=st.models.model_id[m] if multi else None,
        conf_threshold=st.models.conf_threshold[m], on=torch.tensor(True) if multi else None,
        max_depth=st.models.max_depth[m] if multi else 4.5, depth=depth,
        filtered=st.prev_filtered, rgb=torch.from_numpy(f["rgb"]).to(torch.float32),
        mask=torch.zeros(TINY.shape, dtype=torch.int32) if multi else None, tick=None,
    )
    statics = dict(cam=TINY, cfg=cfg, time_delta=3, outlier_coeff=3.0)
    return st.models.store, x, statics


@pytest.mark.parametrize("tick,M", [(6, 1), (7, 1), (7, 3)],
                         ids=["even", "odd", "masked_select"])
def test_device_tick_gives_python_tick_bits(tick, M):
    stores, x, statics = _slot_call(M)
    outs = []
    for t in (tick, torch.tensor(float(tick))):
        own = sm.SurfelStore(*(a.clone() for a in stores))
        res = te._fuse_clean_slot(own, 0, x._replace(tick=t), phase=tick % 2, **statics)
        outs.append(pytree.tree_leaves((own, res)))
    assert len(outs[0]) == len(outs[1]) == 15 + 15 + 6
    assert [i for i, (a, b) in enumerate(zip(*outs)) if not torch.equal(a, b)] == []
    # the pass moved the map
    assert not all(torch.equal(a, b) for a, b in zip(outs[0][:15], stores))


def _key_args():
    """One slot's stores, inputs and settings as `_fuse_clean_all` hands
    them over at one slot (values unused)."""
    cfg = _tiny_cfg(1)
    stores = te._empty_stores(1, cfg.active_capacity, torch.device("cpu"))
    z = torch.zeros(TINY.shape)
    x = SlotInputs(pose=torch.eye(4), weight=torch.ones(()), model_id=None,
                   conf_threshold=torch.ones(()), on=None, max_depth=4.5, depth=z,
                   filtered=z.clone(), rgb=torch.zeros(TINY.shape + (3,)), mask=None,
                   tick=torch.zeros(()))
    return stores, x, dict(cam=TINY, cfg=cfg, time_delta=200, outlier_coeff=3.0)


def _key(stores, m, x, statics):
    """As `_fuse_clean_all` keys slot m's pass."""
    leaves, spec = pytree.tree_flatten(x)
    return graphs.key("fuse_clean", leaves, spec, (m, *statics.items()), stores)


def _changed(change):
    stores, x, statics = _key_args()
    if change == "slot":
        return _key(stores, 1, x, statics)
    if change.startswith("cam."):
        f = change[4:]
        cam = dataclasses.replace(TINY, **{f: getattr(TINY, f) + 8})
        return _key(stores, 0, x, dict(statics, cam=cam))
    if change.startswith("cfg."):
        f, v = change[4:].split("=")
        return _key(stores, 0, x, dict(statics, cfg=statics["cfg"].replace(**{f: int(v)})))
    if change in ("time_delta", "outlier_coeff"):
        return _key(stores, 0, x, dict(statics, **{change: statics[change] * 2}))
    if change == "depth_cutoff":
        return _key(stores, 0, x._replace(max_depth=5.0), statics)
    if change == "mask":
        return _key(stores, 0, x._replace(mask=torch.zeros(TINY.shape, dtype=torch.int32),
                                          model_id=torch.zeros((), dtype=torch.int32)), statics)
    if change == "may_idle":
        return _key(stores, 0, x._replace(on=torch.ones((), dtype=torch.bool)), statics)
    if change == "dtype":
        return _key(stores, 0, x._replace(rgb=x.rgb.double()), statics)
    if change == "shape":
        return _key(stores, 0, x._replace(depth=torch.zeros((TINY.height + 1, TINY.width))),
                    statics)
    if change == "strides":
        return _key(stores, 0, x._replace(depth=x.depth.t().contiguous().t()), statics)
    if change == "store_address":
        return _key(sm.SurfelStore(*(a.clone() for a in stores)), 0, x, statics)
    if change == "store_size":
        return _key(te._empty_stores(1, 1 << 10, torch.device("cpu")), 0, x, statics)
    raise AssertionError(change)


@pytest.mark.parametrize("change", [
    "slot", "cam.fx", "cam.cx", "cfg.assoc_radius=1", "cfg.expel_block_log2=8",
    "cfg.object_active_surfels=512", "time_delta", "outlier_coeff", "depth_cutoff", "mask",
    "may_idle", "dtype", "shape", "strides", "store_address", "store_size",
])
def test_fuse_graph_key_tells_apart(change):
    stores, x, statics = _key_args()
    assert _changed(change) != _key(stores, 0, x, statics)


def test_fuse_graph_key_equal_for_settings_built_afresh():
    stores, x, statics = _key_args()
    again = dict(cam=dataclasses.replace(TINY), cfg=_tiny_cfg(1), time_delta=200,
                 outlier_coeff=3.0)
    assert again["cfg"] is not statics["cfg"]
    fresh = x._replace(pose=torch.eye(4), tick=torch.zeros(()))
    assert _key(stores, 0, fresh, again) == _key(stores, 0, x, statics)
    assert hash(_key(stores, 0, fresh, again)) == hash(_key(stores, 0, x, statics))


def _addresses(stores) -> list:
    return [t.data_ptr() for t in stores]


@pytest.mark.parametrize("mode", ["static", "gt_masks", "close_loops"])
def test_step_keeps_active_tier_addresses(mode):
    """What the graphs read and write in place keeps its address from frame
    to frame: the stacked active tier (and the stable tier's leaves) through
    slot resets (a spawn, a wipe) and `-cl`'s write-back of slot 0."""
    if mode == "gt_masks":
        frames = _gt_frames(TINY, 7, hide=(3,))
        eng = CoFusion(_tiny_cfg(3), fusion_params=_gt_fusion(), enable_multi_model=True,
                       device="cpu")
    else:
        frames, _, _ = make_sequence(TINY, 4, kind="orbit")
        eng = CoFusion(_tiny_cfg(1, deform_nodes=16), fusion_params=FusionParams(depth_cutoff=4.5),
                       device="cpu", close_loops=mode == "close_loops")
    eng.process_frame(frames[0])
    store, stable = _addresses(eng.state.models.store), _addresses(eng.state.models.stable)[:-1]
    spawned = wiped = False
    for f in frames[1:]:
        before = eng.state.models.active.clone()
        eng.process_frame(f)
        after = eng.state.models.active
        spawned |= bool((after & ~before).any())
        wiped |= bool((before & ~after).any())
        assert _addresses(eng.state.models.store) == store
        assert _addresses(eng.state.models.stable)[:-1] == stable
    if mode == "gt_masks":
        assert spawned and wiped
    assert eng.stats()["fuse_graph"]["eager"] == (len(frames) - 1) * eng.cfg.max_models


# ---------------------------------------------------------------------------
# on the card


def _card_cfg(M: int) -> CoFusionConfig:
    return CoFusionConfig(camera=CameraConfig(), max_models=M, max_surfels=1 << 20)


SCENARIOS = {
    # (frames, engine settings) at 640x480; in the GT-mask run slots 1-3
    # spawn at frames 1-3, slot 2's id leaves the view at frame 3 (the slot
    # is wiped), id 3 is hidden at frame 7 (slot 3 wiped) and comes back
    "static_m1": lambda: (make_sequence(CameraConfig(), 14, kind="orbit")[0],
                          dict(cfg=_card_cfg(1), fusion_params=FusionParams(depth_cutoff=4.5))),
    "gtmask_m4": lambda: (_gt_frames(CameraConfig(), 14, hide=(7,)),
                          dict(cfg=_card_cfg(4), fusion_params=_gt_fusion(),
                               enable_multi_model=True)),
    "close_loops_m1": lambda: (make_sequence(CameraConfig(), 12, kind="orbit")[0],
                               dict(cfg=_card_cfg(1), fusion_params=FusionParams(depth_cutoff=4.5),
                                    close_loops=True)),
}


@pytest.fixture(scope="module", params=list(SCENARIOS))
def run(request, card):
    """Both engines over the scenario's frames: per frame the state leaves
    that differ, the graphed engine's counters and the active flags; a map
    downloaded at frame 6, and again after frames 7 and 8."""
    frames, settings = SCENARIOS[request.param]()
    graphed, eager = pair(card, settings)
    diffs, counts, active = [], [], []
    kept = None
    for i, f in enumerate(frames):
        graphed.process_frame(f)
        eager.process_frame(f)
        torch.cuda.synchronize()
        diffs.append(diff(graphed, eager))
        counts.append(graphed.graphs.counts("fuse_clean"))
        active.append(graphed.state.models.active.cpu().numpy())
        if i == 6:
            kept = graphed.download_model(0)
            copy = {k: v.copy() for k, v in kept.items()}
            ref = eager.download_model(0)
    return dict(name=request.param, M=graphed.cfg.max_models, diffs=diffs, counts=counts,
                active=np.stack(active), kept=kept, copy=copy, ref=ref)


def test_graphed_bit_equal_to_eager(run):
    assert [(i, d) for i, d in enumerate(run["diffs"]) if d] == []
    assert len(run["diffs"]) >= 12
    if run["name"] == "gtmask_m4":
        on = run["active"][:, 1:]
        assert (on[1:] & ~on[:-1]).any() and (~on[1:] & on[:-1]).any(), run["active"]


def test_counters(run):
    """Frame 1 initialises; each slot's first pass (frame 2) runs eagerly,
    frames 3 and 4 capture the two stagger phases' graphs, every later
    frame replays one graph a slot."""
    M, n = run["M"], len(run["counts"])
    assert run["counts"][-1] == dict(captures=2 * M, replays=(n - 2) * M, eager=M, evictions=0)
    for prev, now in zip(run["counts"][4:], run["counts"][5:]):
        assert now == dict(prev, replays=prev["replays"] + M)


def test_downloaded_map_unchanged_by_next_replays(run):
    for k, v in run["kept"].items():
        np.testing.assert_array_equal(v, run["copy"][k], err_msg=k)
        np.testing.assert_array_equal(v, run["ref"][k], err_msg=k)


@pytest.mark.parametrize("scenario", ["static_m1", "gtmask_m4"])
def test_new_outlier_coeff_recaptures(card, scenario):
    frames, settings = SCENARIOS[scenario]()
    graphed, eager = pair(card, settings)
    M = graphed.cfg.max_models
    for i, f in enumerate(frames[:10]):
        if i == 5:
            for e in (graphed, eager):
                e.set_params(outlier_coefficient=1.5)
            before = graphed.graphs.counts("fuse_clean")
        graphed.process_frame(f)
        eager.process_frame(f)
        assert diff(graphed, eager) == [], f"frame {i}"
    # the new setting's first pass eager, then both phases captured anew
    assert graphed.graphs.counts("fuse_clean") == dict(
        captures=before["captures"] + 2 * M, replays=before["replays"] + 4 * M,
        eager=before["eager"] + M, evictions=0)


def test_sharded_state_runs_eager_on_the_card(card):
    frames, _, _ = make_sequence(CameraConfig(), 5, kind="orbit")
    eng = CoFusion(_card_cfg(1), fusion_params=FusionParams(depth_cutoff=4.5), device=card)
    eng.process_frame(frames[0])
    mesh = make_mesh(2, "cuda", virtual=torch.cuda.device_count() < 2)
    eng.state = shard_engine_state(eng.state, mesh)
    for f in frames[1:]:
        eng.process_frame(f)
    assert eng.stats()["fuse_graph"] == dict(captures=0, replays=0, eager=4, evictions=0)
