"""The port's sharded engine state under relocalisation ('-rl'), loop
closure ('-cl') and `CoFusion.render_views` — the loop block's graph
sampling over both tiers' shards, its per-shard warp and timestamp
refresh, the stable -> active tier exchange — on the CPU at n = 1, 2 and
8 shards (`make_mesh(n, "cpu")`), bit for bit the unsharded port:

  (a) the primitives on stores built so that the picked ranks and the
      valid rows straddle shard boundaries in both tiers:
      `deformation.sample_graph_tiers` (which must not build the
      concatenation of the tiers) against `concat_stores` +
      `sample_graph`; `apply_to_surfels` and `refresh_timestamps`, then
      the refreshed stable tier's expel into the active tier;
  (b) tests/test_local_loop.py's drift run at 160x128 with '-rl -cl' and
      a short time window (time delta 3, expel blocks of 2^13): the map
      is aged to an old positive stamp and the camera drifts by
      (3, 1.5, 0) cm after frame 6, so the stable tier fills and a loop
      closes with old geometry in both tiers (and stable surfels go back
      to the active tier);
  (c) tests/test_torch_reloc.py's blackout run ('-rl'): lost in the
      blackout, recovered after it;
  (d) `render_views` on an 80x64 orbit's state at time delta 1 (both
      tiers render);
  (e) a multi-model drift run with '-cl' (3 slots, ground-truth masks
      with a moving object in slot 1) at 8 shards: only slot 0 loops,
      the object slot is written back untouched by the loop block;
  (f) the drift run's closing frame replayed through the JAX package's
      jitted unsharded `_step(use_reloc=True, close_loops=True)` from the
      port's gathered sharded state, under the bars of
      tests/test_torch_local_loop.py (ROADMAP C8's condition scale, C11's
      count overlap).  JAX's sharded step is not run (ROADMAP C7).

Bars of (b)-(e): every frame's whole state (both tiers of every slot
gathered, counts, poses, flags, `lost`, the fern database, the pose and
mask rings, the carried prediction), the step outputs (`loop_closed`
among them), the rendered views and (b) the read-outs and a checkpoint
resumed whole equal the unsharded port's exactly.
Each run (unsharded or on n shards) is computed once per test session, by
whichever test asks first on any worker, and shared with the others
through the session's temporary directory (tests/torch_shared.py).
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu.config import CameraConfig as JCameraConfig
from cofusion_tpu.config import CoFusionConfig as JCoFusionConfig
from cofusion_tpu.config import FusionParams as JFusionParams
from cofusion_tpu.engine import CoFusion as JaxCoFusion
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch import convert
from cofusion_tpu_torch.engine import CoFusion
from cofusion_tpu_torch.io.synthetic import make_sequence
from cofusion_tpu_torch.models import surfel_model as sm
from cofusion_tpu_torch.ops import deformation as df
from cofusion_tpu_torch.ops.lie import se3_exp_rt
from cofusion_tpu_torch.parallel import shard_engine_state
from cofusion_tpu_torch.utils import checkpoint

import test_torch_local_loop as tl
import test_torch_parallel as tp
import test_torch_reloc as tr
from torch_shared import shared  # noqa: F401  (a fixture)

torch.set_num_threads(1)
SHARDS = [1, 2, 8]
CAM = dict(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
DRIFT_CFG = dict(max_models=1, max_surfels=1 << 16, active_surfels=1 << 15, expel_block_log2=13,
                 deform_nodes=64, cons_sample=8, time_delta=3)
DRIFT_FRAMES, DRIFT_AT = 10, 6
AGED_TIME = 1.0  # an old positive stamp: the aged map ages out into the stable tier


def _drift_engine():
    return CoFusion(tcfg.CoFusionConfig(camera=tcfg.CameraConfig(**CAM), **DRIFT_CFG),
                    fusion_params=tcfg.FusionParams(**tl.FUSION), enable_relocalization=True,
                    close_loops=True, device="cpu")


def _age_and_drift(eng):
    """Slot 0's active surfels stamped AGED_TIME (in place, shard by
    shard) and tl.DRIFT added to the camera."""
    st = eng.state
    for s in sm.shards_of(st.models.store)[0]:
        s.last_time[0].copy_(torch.where(s.valid[0], AGED_TIME, s.last_time[0]))
    pose = st.models.pose.clone()
    pose[0, :3, 3] += torch.from_numpy(tl.DRIFT)
    eng.state = st._replace(models=st.models._replace(pose=pose))


def _play(eng, frames, n=None, hooks=None):
    """process_frame over `frames`, the state sharded over n CPU shards
    after the first; per frame the gathered numpy state and the outputs."""
    hooks = hooks or {}
    snaps, outs = [], []
    for i, f in enumerate(frames):
        if i in hooks:
            hooks[i](eng)
        eng.process_frame(f)
        if i == 0 and n is not None:
            eng.state = shard_engine_state(eng.state, tp._cpu_mesh(n))
        if i > 0:
            assert tp._is_sharded(eng.state) == (n is not None)
            outs.append(jax.tree.map(tp._np, eng._last_outputs))
        snaps.append(tp._snapshot(eng.state))
    return snaps, outs


def _drift_frames():
    return make_sequence(tcfg.CameraConfig(**CAM), DRIFT_FRAMES, kind="still")[0]


def _drift_run(shared, n=None):
    return shared.get(f"parallel_loop_drift_{n}", lambda: _compute_drift_run(n))


def _compute_drift_run(n=None):
    """The drift run, unsharded (n None) or on n shards; then the final
    read-outs and the state a checkpoint of the engine resumes in a new,
    unsharded one."""
    eng = _drift_engine()
    snaps, outs = _play(eng, _drift_frames(), n, {DRIFT_AT: _age_and_drift})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "drift.ckpt")
        checkpoint.save_engine(eng, path)
        whole = _drift_engine()
        checkpoint.load_engine(whole, path)
    return dict(snaps=snaps, outs=outs, closed_at=[k for k, o in enumerate(outs, 1) if o.loop_closed],
                reads=eng.download_model(0), count=eng.surfel_count(0),
                poses=[p for _, p in eng.pose_log], resumed=tp._snapshot(whole.state))


def _assert_runs_equal(got, ref):
    for k, (g, r) in enumerate(zip(got["snaps"], ref["snaps"])):
        tp._assert_same(g, r, f"frame {k}")
    tp._assert_same(got["outs"], ref["outs"], "outputs")


# ---------------------------------------------------------------------------
# (a) the primitives


def _tier(rng, n, rows, cam, t0):
    """A tier of `n` rows whose valid rows are `rows` (anywhere), init
    times from t0 up."""
    valid = torch.zeros(n, dtype=torch.bool)
    valid[torch.from_numpy(rows)] = True
    full = tp._random_store(rng, n, n, cam)
    out = {f: torch.where(valid, getattr(full, f), 0.0) for f in sm.DATA_FIELDS[:-1]}
    out["init_time"] = torch.where(valid, t0 + torch.arange(n, dtype=torch.float32) / 64, 0.0)
    return sm.SurfelStore(**out, valid=valid, count=torch.tensor(len(rows), dtype=torch.int32))


def _tier_cases(rng, cam):
    """(stable, active) pairs of 1024 and 512 rows: valid rows spread over
    every shard of both tiers, clustered around the shard boundaries, one
    tier empty, both empty, fewer valid rows than nodes."""
    S, A = 1024, 512
    spread = lambda n, k: np.sort(rng.choice(n, k, replace=False))
    around = lambda n, w: np.unique(np.concatenate([np.arange(max(0, b - w), min(n, b + w))
                                                    for b in range(0, n + 1, n // 8)]))
    return [
        (spread(S, 700), spread(A, 300)),
        (around(S, 5), around(A, 7)),
        (np.array([], np.int64), spread(A, 200)),
        (spread(S, 333), np.array([], np.int64)),
        (np.array([], np.int64), np.array([], np.int64)),
        (spread(S, 11), spread(A, 9)),
    ]


@pytest.mark.parametrize("n", SHARDS)
def test_sample_graph_tiers_sharded(n, monkeypatch):
    rng = np.random.default_rng(70 + n)
    cam = tcfg.CameraConfig(width=24, height=16, fx=20.0, fy=20.0, cx=12.0, cy=8.0)
    devices = tp._cpu_mesh(n).devices
    for case, (s_rows, a_rows) in enumerate(_tier_cases(rng, cam)):
        stable, active = _tier(rng, 1024, s_rows, cam, 1.0), _tier(rng, 512, a_rows, cam, 40.0)
        for G in (64, 256):
            ref = df.sample_graph(sm.concat_stores(stable, active), G)
            with monkeypatch.context() as m:
                # the sharded route builds no whole (S + A)-row store
                m.setattr(sm, "concat_stores", None)
                got = df.sample_graph_tiers(sm.shard_store(stable, devices),
                                            sm.shard_store(active, devices), G)
            tp._assert_same(got, ref, f"graph, case {case}, G {G}")
            assert int(ref.count) == min(len(s_rows) + len(a_rows), G)
    # the unsharded tiers take concat_stores + sample_graph as they are
    tp._assert_same(df.sample_graph_tiers(stable, active, 64),
                    df.sample_graph(sm.concat_stores(stable, active), 64), "plain")


@pytest.mark.parametrize("n", SHARDS)
def test_warp_refresh_and_exchange_sharded(n):
    """A graph sampled from both tiers and moved (random node rotations
    and translations) warps both tiers, re-stamps them from their
    synthesized depth at a moved pose, and the stable tier's refreshed
    rows go to the active tier, as `engine._close_loop` does."""
    rng = np.random.default_rng(80 + n)
    cam = tcfg.CameraConfig(width=24, height=16, fx=20.0, fy=20.0, cx=12.0, cy=8.0)
    devices = tp._cpu_mesh(n).devices
    s_rows, a_rows = _tier_cases(rng, cam)[0]
    stable, active = _tier(rng, 1024, s_rows, cam, 1.0), _tier(rng, 512, a_rows, cam, 40.0)
    graph = df.sample_graph_tiers(stable, active, 64)
    xi = torch.from_numpy(rng.normal(scale=0.02, size=(64, 6)).astype(np.float32))
    moved = se3_exp_rt(xi)
    graph = graph._replace(R=moved[:, :3, :3], t=moved[:, :3, 3])
    pose = se3_exp_rt(torch.tensor([0.01, -0.02, 0.015, 0.01, 0.0, -0.01]))
    conf, tick, block = torch.tensor(2.0), 50, 128

    def loop_block(st, ac):
        ws = df.refresh_timestamps(df.apply_to_surfels(graph, st), pose, cam, tick, 3.0, conf)
        wa = df.refresh_timestamps(df.apply_to_surfels(graph, ac), pose, cam, tick, 3.0, conf)
        fresh = sm.per_shard(ws, lambda s: s.valid & (s.last_time >= float(tick)))
        st_new, blk = sm.expel_split(ws, sm.per_shard(ws, lambda s: s.valid), fresh, block)
        return ws, wa, st_new, blk, sm.append(wa, blk, blk.valid)

    ref = loop_block(stable, active)
    got = loop_block(sm.shard_store(stable, devices), sm.shard_store(active, devices))
    for name, g, r in zip(("warped stable", "warped active", "stable", "block", "active"), got, ref):
        tp._assert_same(sm.gathered(g), r, name)
    assert int((ref[0].last_time == tick).sum()) > 0 and 0 < int(ref[3].count) <= block
    assert not torch.equal(ref[0].px, stable.px)


# ---------------------------------------------------------------------------
# (b) the drift run, (d) render_views


def test_drift_reference_closes_with_both_tiers(shared):
    ref = _drift_run(shared)
    k = ref["closed_at"][0]
    before, after = ref["snaps"][k - 1].models, ref["snaps"][k].models
    assert k > DRIFT_AT and int(before.stable.valid[0].sum()) > 1000
    # the closure brought refreshed stable surfels back to the active tier
    assert int(after.stable.valid[0].sum()) < int(before.stable.valid[0].sum())
    assert not any(bool(s.lost) for s in ref["snaps"]) and int(ref["snaps"][-1].fern_db.count) >= 1


@pytest.mark.parametrize("n", SHARDS)
def test_drift_run_sharded(n, shared):
    """Every frame, then the read-outs (`download_model`, `surfel_count`,
    the pose log) and a checkpoint of the sharded engine, resumed whole."""
    got, ref = _drift_run(shared, n), _drift_run(shared)
    _assert_runs_equal(got, ref)
    assert got["count"] == ref["count"] and got["reads"].keys() == ref["reads"].keys()
    for key in ref["reads"]:
        np.testing.assert_array_equal(got["reads"][key], ref["reads"][key], err_msg=key)
    np.testing.assert_array_equal(np.stack(got["poses"]), np.stack(ref["poses"]))
    tp._assert_same(got["resumed"], ref["snaps"][-1], "resumed")


def _views_engine():
    cfg = dict(tl.LOOP_CFG, time_delta=1, active_surfels=1 << 13, expel_block_log2=11)
    return CoFusion(tcfg.CoFusionConfig(camera=tcfg.CameraConfig(**tl.LOOP_CAM), **cfg),
                    fusion_params=tcfg.FusionParams(**tl.FUSION), device="cpu")


def _views_state(shared):
    """An 80x64 orbit of 6 frames at time delta 1: what the orbit leaves
    behind ages into the stable tier, so both tiers render."""
    def run():
        eng = _views_engine()
        for f in make_sequence(eng.cam, 6, kind="orbit")[0]:
            eng.process_frame(f)
        return tp._snapshot(eng.state)

    return shared.get("parallel_loop_views", run)


@pytest.mark.parametrize("n", SHARDS)
def test_render_views_sharded(n, shared):
    snap = _views_state(shared)
    eng = _views_engine()
    eng.state = convert.state_from_numpy(snap)
    ref = eng.render_views()
    stable_only = eng.state.models._replace(store=eng.state.models.store._replace(
        valid=torch.zeros_like(eng.state.models.store.valid)))
    eng.state = eng.state._replace(models=stable_only)
    stable_view = eng.render_views()
    eng.state = shard_engine_state(convert.state_from_numpy(snap), tp._cpu_mesh(n))
    got = eng.render_views()
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    # both tiers show: the stable tier alone covers part of the view
    assert 0 < int(stable_view["valid"].sum()) < int(ref["valid"].sum()), (
        int(stable_view["valid"].sum()), int(ref["valid"].sum()))


# ---------------------------------------------------------------------------
# (c) the blackout run


def _blackout_run(shared, n=None):
    return shared.get(f"parallel_loop_blackout_{n}", lambda: _compute_blackout_run(n))


def _compute_blackout_run(n=None):
    cam = tcfg.CameraConfig(**CAM)
    eng = CoFusion(tcfg.CoFusionConfig(camera=cam, max_models=1, max_surfels=1 << 16),
                   fusion_params=tcfg.FusionParams(**tr.FUSION), enable_relocalization=True,
                   device="cpu")
    snaps, outs = _play(eng, tr._blackout_frames(cam), n)
    return dict(snaps=snaps, outs=outs)


@pytest.mark.parametrize("n", SHARDS)
def test_blackout_run_sharded(n, shared):
    got = _blackout_run(shared, n)
    ref = _blackout_run(shared)
    lost = [bool(s.lost) for s in ref["snaps"]]
    assert not any(lost[:6]) and any(lost[6:20]) and not lost[-1], lost
    _assert_runs_equal(got, ref)


# ---------------------------------------------------------------------------
# (e) multi-model with '-cl'


def test_multi_model_drift_sharded_8():
    frames, _, _ = make_sequence(tcfg.CameraConfig(**tl.LOOP_CAM), 10, kind="still",
                                 moving_object=True)
    cfg = tcfg.CoFusionConfig(camera=tcfg.CameraConfig(**tl.LOOP_CAM),
                              **dict(tl.LOOP_CFG, max_models=3, time_delta=3,
                                     active_surfels=1 << 13, expel_block_log2=11))
    fusion = tcfg.FusionParams(**dict(tl.FUSION, model_spawn_offset=2))
    runs = {}
    for n in (None, 8):
        eng = CoFusion(cfg, fusion_params=fusion, enable_multi_model=True, close_loops=True,
                       device="cpu")
        runs[n] = dict(zip(("snaps", "outs"), _play(eng, frames, n, {DRIFT_AT: _age_and_drift})))
    _assert_runs_equal(runs[8], runs[None])
    outs, last = runs[None]["outs"], runs[None]["snaps"][-1].models
    closed = [k for k, o in enumerate(outs, 1) if o.loop_closed]
    assert closed and closed[0] > DRIFT_AT, closed
    assert bool(last.active[1]) and int(last.store.count[1]) > 0


# ---------------------------------------------------------------------------
# (f) the closing frame through the JAX package's unsharded step


def test_closing_frame_replayed_through_jax(monkeypatch, shared):
    frames = _drift_frames()
    run = _drift_run(shared, 8)
    k = run["closed_at"][0]
    before, after = run["snaps"][k - 1], run["snaps"][k]
    teng = _drift_engine()
    conds = tl.Conditions(monkeypatch)
    port, closed = tl.port_step(teng, before, frames[k])
    scale = tl._scale(conds.take())
    tp._assert_same(port, after, "the unsharded port's step from the gathered state")

    jcam = JCameraConfig(**CAM)
    jeng = JaxCoFusion(JCoFusionConfig(camera=jcam, **DRIFT_CFG),
                       fusion_params=JFusionParams(**tl.FUSION), enable_relocalization=True,
                       close_loops=True)
    f = frames[k]
    rgb, depth = jnp.asarray(f["rgb"], jnp.float32), jnp.asarray(f["depth"])
    mask = jnp.asarray(f["mask"], jnp.int32)
    # the state's structure, traced but not run
    jeng.state = jax.eval_shape(jeng._init_state, rgb, depth, mask)
    call = (jeng._get_step(False),
            (rgb, depth, mask, jeng._make_fparams(1.0, -1, False, f["mask"], None)))
    ref, jclosed = tl.jax_step(jeng, call, before)
    pose, counts, lost = tl._summary(ref)
    tpose, tcounts, tlost = tl._summary(after)
    assert jclosed and closed and lost == tlost, (jclosed, closed, lost, tlost)
    print("closing frame", k, "JAX step from the port's sharded state |d| =",
          float(np.abs(pose - tpose).max()), "bar", tl.STEP_BAR * scale)
    np.testing.assert_allclose(pose, tpose, atol=tl.STEP_BAR * scale)
    if not np.array_equal(counts, tcounts):
        # ROADMAP C11: both engines step again under about an ulp of depth noise
        noised = [tl._ulp_noised(frames[k], seed) for seed in tl.NOISE_SEEDS]
        jn = np.stack([counts] + [tl._summary(tl.jax_step(jeng, call, before, f)[0])[1]
                                  for f in noised])
        tn = np.stack([tcounts] + [tl._summary(tl.port_step(teng, before, f)[0])[1]
                                   for f in noised])
        print("counts part:", tcounts, counts, "under ulp noise: JAX", jn[1:].tolist(), "port",
              tn[1:].tolist())
        assert (np.maximum(jn.min(0), tn.min(0)) <= np.minimum(jn.max(0), tn.max(0))).all(), (
            jn.tolist(), tn.tolist())
