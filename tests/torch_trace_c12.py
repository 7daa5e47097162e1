"""The traces behind ROADMAP C12: why a loop closure turns a ~1e-5 state
difference into millimetres of camera pose, and whose behaviour that is.
Not collected by pytest (each trace compiles the JAX step; 2-4 minutes
each):

    JAX_PLATFORMS=cpu python tests/torch_trace_c12.py closing-noise
    JAX_PLATFORMS=cpu python tests/torch_trace_c12.py run-noise [--seeds 10]
    JAX_PLATFORMS=cpu python tests/torch_trace_c12.py stages

All three run tests/test_local_loop.py's engine drift scenario in the
configuration of tests/test_torch_local_loop.py (80x64, 2^14 surfels, 64
deformation nodes; the map aged out of the window and the camera drifted
by (3, 1.5, 0) cm before frame 6); the loop closes at frame 9 in both
engines.

closing-noise  both engines run to frame 8; the closing step (frame 9) is
               stepped from each engine's own state with about an ulp of
               noise on the depth frame (`_ulp_noised`, 6 seeds): the
               spread of each engine's camera pose after the step.
run-noise      the whole run again from frame 1 with that noise on every
               frame's depth (a new draw per frame and seed) in both
               engines: frame 8's surfel count and the camera after the
               closing step, against each engine's run without noise.
               This is what separates two devices' runs: rounding on
               every frame, not one frame's input.
stages         from the JAX run's state before frame 9, the inputs of the
               port's closing block (`engine._close_loop`) go through the
               JAX package's functions one stage at a time: the two
               renders, `local_loop` (its model-to-model Gauss-Newton
               traced iteration by iteration at level 0, in both engines,
               on the JAX renders), constraint sampling, `sample_graph`,
               the time k-NN, the graph solve, the pose warp (the port's
               polar factor against JAX's SVD) and `refresh_timestamps`.
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_local_loop as L  # noqa: E402
from cofusion_tpu.config import CoFusionConfig, TrackingParams  # noqa: E402
from cofusion_tpu.io.synthetic import make_sequence  # noqa: E402
from cofusion_tpu.models import surfel_model as jsm  # noqa: E402
from cofusion_tpu.ops import deformation as jdf  # noqa: E402
from cofusion_tpu.ops import local_loop as jll  # noqa: E402
from cofusion_tpu.ops import rasterize as jrz  # noqa: E402
from cofusion_tpu_torch import engine as teng_mod  # noqa: E402
from cofusion_tpu_torch.models import surfel_model as tsm  # noqa: E402
from cofusion_tpu_torch.ops import deformation as tdf  # noqa: E402
from cofusion_tpu_torch.ops import local_loop as tll  # noqa: E402
from cofusion_tpu_torch.ops import rasterize as trz  # noqa: E402

N_WARM, N_FRAMES, CLOSING = 6, 10, 9


def _runs():
    """Both engines' drift runs: frames, the recorded JAX step calls, and
    each run's (log, numpy state before every step)."""
    cam, _ = L._cams()
    frames, _, _ = make_sequence(cam, N_FRAMES, kind="still")
    jeng, teng = L._engines()
    calls = L._record_steps(jeng)
    jlog, jbefore, _ = L.play(jeng, frames, {N_WARM: L._drift_hook(jnp)})
    tlog, tbefore, _ = L.play(teng, frames, {N_WARM: L._drift_hook(torch)})
    closed = ([k for k, r in enumerate(jlog) if r[3]], [k for k, r in enumerate(tlog) if r[3]])
    print("loop closed at: JAX", closed[0], "port", closed[1])
    assert closed[0] == closed[1] == [CLOSING], closed
    return frames, jeng, teng, calls, (jlog, jbefore), (tlog, tbefore)


def _drifted(state):
    """The drift hook on a numpy state."""
    m, s = state.models, state.models.store
    pose = np.array(m.pose)
    pose[0, :3, 3] += L.DRIFT
    aged = np.where(s.valid, -500.0, s.last_time).astype(np.float32)
    return state._replace(models=m._replace(pose=pose, store=s._replace(last_time=aged)))


def closing_noise(opts):
    frames, jeng, teng, calls, (jlog, jb), (tlog, tb) = _runs()
    k = CLOSING
    for name, log, step, state in (
        ("JAX", jlog, lambda st, f: L.jax_step(jeng, calls[k - 1], st, f), jb[k]),
        ("port", tlog, lambda st, f: L.port_step(teng, st, f), tb[k]),
    ):
        poses, counts = [], []
        for seed in L.NOISE_SEEDS:
            new, closed = step(state, L._ulp_noised(frames[k], seed))
            assert closed
            pose, c, _ = L._summary(new)
            poses.append(pose)
            counts.append(int(c[0]))
        P = np.stack(poses)
        print(f"{name}: closing step from its own state under ulp depth noise ({len(P)} seeds): "
              f"camera spread {(P.max(0) - P.min(0)).max():.3e}, largest distance from its run "
              f"{np.abs(P - log[k][0]).max():.3e}, counts {counts}")
    print("the two runs before the closing step: camera", f"{np.abs(jlog[k - 1][0] - tlog[k - 1][0]).max():.3e}",
          "counts", jlog[k - 1][1].tolist(), tlog[k - 1][1].tolist(), "; after it:",
          f"{np.abs(jlog[k][0] - tlog[k][0]).max():.3e}")


def run_noise(opts):
    frames, jeng, teng, calls, (jlog, jb), (tlog, tb) = _runs()
    final = {"JAX": [], "port": []}
    for seed in range(opts.seeds):
        sj, st = jb[1], tb[1]
        line = []
        for k in range(1, N_FRAMES):
            if k == N_WARM:
                sj, st = _drifted(sj), _drifted(st)
            f = L._ulp_noised(frames[k], 1000 + 100 * seed + k)
            sj, _ = L.jax_step(jeng, calls[k - 1], sj, f)
            st, _ = L.port_step(teng, st, f)
            if k == CLOSING - 1:
                line.append(f"frame {k} counts JAX {L._summary(sj)[1][0]} port {L._summary(st)[1][0]}")
        pj, pt = L._summary(sj)[0], L._summary(st)[0]
        final["JAX"].append(pj)
        final["port"].append(pt)
        print(f"seed {seed}: {line[0]}; camera after the closing step, off its run without noise: "
              f"JAX {np.abs(pj - jlog[CLOSING][0]).max():.3e}, port {np.abs(pt - tlog[CLOSING][0]).max():.3e}",
              flush=True)
    for name, P in final.items():
        P = np.stack(P)
        print(f"{name}: camera spread after the closing step over {len(P)} seeds "
              f"{(P.max(0) - P.min(0)).max():.3e}")
    print("runs without noise: frame 8 counts JAX", jlog[CLOSING - 1][1][0], "port", tlog[CLOSING - 1][1][0])


def _j(tree) -> list:
    """The leaves of a NamedTuple of tensors as JAX arrays."""
    return [jnp.asarray(a.numpy()) for a in tree]


def _diff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(np.where(both, a - b, 0.0)).max()) if a.size else 0.0


def stages(opts):
    frames, jeng, teng, calls, (jlog, jb), (tlog, tb) = _runs()
    k = CLOSING
    cam, tcam = L._cams()
    jcfg = CoFusionConfig(camera=cam, **L.LOOP_CFG)
    rec = []
    close = teng_mod._close_loop

    def recording(*a, **kw):
        rec.append(a)
        return close(*a, **kw)

    teng_mod._close_loop = recording
    try:
        L.port_step(teng, jb[k], frames[k])
    finally:
        teng_mod._close_loop = close
    state, store0, stable0, pose0, conf0, lost, fern, tc, cfg, tparams, fparams, tick = rec[0]
    td, dc = fparams["time_delta"], fparams["depth_cutoff"]
    js0, jst0 = jsm.SurfelStore(*_j(store0)), jsm.SurfelStore(*_j(stable0))
    jpose0, jconf = jnp.asarray(pose0.numpy()), jnp.float32(float(conf0))
    jtick = jnp.int32(state.tick)

    # 1. the renders
    ract = lambda: (jrz.splat_predict(js0, jpose0, cam, jcfg, jtick, td, dc, jconf),
                    trz.splat_predict(store0, pose0, tcam, cfg, state.tick, td, dc, conf0))
    jact, tact = ract()
    jold = jrz.splat_merge(
        jrz.splat_predict(js0, jpose0, cam, jcfg, jtick, td, dc, jconf, active_window=False),
        jrz.splat_predict(jst0, jpose0, cam, jcfg, jtick, td, dc, jconf, active_window=False))
    told = trz.splat_merge(
        trz.splat_predict(store0, pose0, tcam, cfg, state.tick, td, dc, conf0, active_window=False),
        trz.splat_predict(stable0, pose0, tcam, cfg, state.tick, td, dc, conf0, active_window=False))
    for name, a, b in (("active", jact, tact), ("inactive", jold, told)):
        print(f"render {name}: valid pixels {int(np.asarray(a.valid).sum())}, differing "
              f"{int((np.asarray(a.valid) != b.valid.numpy()).sum())}; vertex {_diff(a.vert_conf[..., :3], b.vert_conf[..., :3]):.2e}, "
              f"normal {_diff(a.normal_rad[..., :3], b.normal_rad[..., :3]):.2e}, colour {_diff(a.image, b.image):.2e}")

    # 2. the local loop on JAX's renders, and its level-0 Gauss-Newton
    npx = cam.width * cam.height / (640.0 * 480.0)
    gates = (fparams["loop_cov_thresh"] / npx, fparams["loop_err_thresh"], fparams["loop_count_thresh"] * npx)
    t_old = trz.SplatMap(*(torch.from_numpy(np.array(a)) for a in jold))
    t_act = trz.SplatMap(*(torch.from_numpy(np.array(a)) for a in jact))

    def jax_ll(iters=None):
        c = jcfg if iters is None else jcfg.replace(gn_iters=iters)
        fn = jax.jit(lambda old, pose, act: jll.local_loop(
            old, pose, act, cam, c, TrackingParams(), jtick, jnp.int32(td), jnp.float32(dc), jconf,
            *(jnp.float32(g) for g in gates)))
        return fn(jold, jpose0, jact)

    def port_ll(iters=None):
        c = cfg if iters is None else cfg.replace(gn_iters=iters)
        return tll.local_loop(t_old, pose0, t_act, tcam, c, tparams, state.tick, td, dc, conf0, *gates)

    jr, tr = jax_ll(), port_ll()
    print(f"local_loop: est_pose {_diff(jr.est_pose, tr.est_pose):.2e}, icp_count {float(jr.icp_count)} / "
          f"{float(tr.icp_count)}, accepted {bool(jr.accepted)} / {bool(tr.accepted)}, constraints "
          f"{int(jr.num_constraints)} / {int(tr.num_constraints)} (valid equal "
          f"{np.array_equal(np.asarray(jr.cons_valid), tr.cons_valid.numpy())}), src {_diff(jr.src, tr.src):.2e}, "
          f"tgt {_diff(jr.tgt, tr.tgt):.2e}; correction {np.round((tr.est_pose[:3, 3] - pose0[:3, 3]).numpy() * 1e3, 3)} mm")
    n0 = cfg.gn_iters[0]
    prev = None
    for it in range(1, 2 * n0 + 1):
        je, te = np.asarray(jax_ll((it,) + cfg.gn_iters[1:]).est_pose), port_ll((it,) + cfg.gn_iters[1:]).est_pose.numpy()
        step = "" if prev is None else f", step JAX {np.abs(je - prev[0]).max():.2e} port {np.abs(te - prev[1]).max():.2e}"
        mark = "  <- the engines' count" if it == n0 else ""
        print(f"  level-0 iterations {it:2d}: t JAX {np.round(je[:3, 3] * 1e3, 4)} mm, |JAX - port| "
              f"{np.abs(je - te).max():.2e}{step}{mark}")
        prev = (je, te)

    # 3. the graph: sampled nodes, k-NN, solve, pose warp, timestamps, all
    # on JAX's constraints
    src, tgt, valid = jr.src, jr.tgt, jr.cons_valid
    times = jnp.full((src.shape[0],), float(tick), jnp.float32)
    jg = jdf.sample_graph(jsm.concat_stores(jst0, js0), jcfg.deform_nodes)
    tg = tdf.sample_graph(tsm.concat_stores(stable0, store0), cfg.deform_nodes)
    print("sample_graph: nodes", int(jg.count), "/", int(tg.count), "positions equal",
          np.array_equal(np.asarray(jg.positions), tg.positions.numpy()), "times equal",
          np.array_equal(np.asarray(jg.times), tg.times.numpy()))
    tsrc, ttimes = torch.from_numpy(np.array(src)), torch.from_numpy(np.array(times))
    jn, jw = jdf._knn_time_weights(jg, src, times)
    tn, tw = tdf._knn_time_weights(tg, tsrc, ttimes)
    print("time k-NN: indices equal", np.array_equal(np.asarray(jn), tn.numpy()), f"weights {_diff(jw, tw):.2e}")
    jgo, jerr = jdf.optimize(jg, src, times, tgt, valid)
    tgo, terr = tdf.optimize(tg, tsrc, ttimes, torch.from_numpy(np.array(tgt)), torch.from_numpy(np.array(valid)))
    print(f"graph solve: R {_diff(jgo.R, tgo.R):.2e}, t {_diff(jgo.t, tgo.t):.2e}, error {float(jerr):.4e} / {float(terr):.4e}")
    hist = state.pose_history[:, 0]
    cap = cfg.max_log_frames
    hist_t = ((tick - 1) - np.mod(tick - 2 - np.arange(cap), cap)).astype(np.float32)
    jh = jdf.apply_to_poses(jgo, jnp.asarray(hist.numpy()), jnp.asarray(hist_t))
    th = tdf.apply_to_poses(tgo, hist, torch.from_numpy(hist_t))
    live = slice(0, tick - 1)
    print(f"pose warp (polar factor against the SVD): {_diff(np.asarray(jh)[live], th.numpy()[live]):.2e}")
    ja = jdf.refresh_timestamps(jdf.apply_to_surfels(jgo, js0), jr.est_pose, cam, tick, dc, jconf)
    ta = tdf.refresh_timestamps(tdf.apply_to_surfels(tgo, store0), tr.est_pose, tcam, tick, dc, conf0)
    print("refresh_timestamps: last_time equal", np.array_equal(np.asarray(ja.last_time), ta.last_time.numpy()),
          f"positions {_diff(ja.px, ta.px):.2e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", choices=("closing-noise", "run-noise", "stages"))
    ap.add_argument("--seeds", type=int, default=10)
    opts = ap.parse_args(argv)
    torch.set_num_threads(1)
    {"closing-noise": closing_noise, "run-noise": run_noise, "stages": stages}[opts.trace](opts)


if __name__ == "__main__":
    main()
