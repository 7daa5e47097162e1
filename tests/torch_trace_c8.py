"""The traces behind ROADMAP C8: where the port's and the JAX engine's object
poses part, and why.  Not collected by pytest (each trace compiles the JAX
step; minutes each):

    JAX_PLATFORMS=cpu python tests/torch_trace_c8.py crf-inputs [--plain-luma]
    JAX_PLATFORMS=cpu python tests/torch_trace_c8.py gt-pred
    JAX_PLATFORMS=cpu python tests/torch_trace_c8.py bench-slot [--frame 37]

crf-inputs   tests/test_torch_crf_engine.py's teleport run: from the JAX
             state before frame 7 (the spawned object's first tracking
             step), the port's `track_models` on its own inputs and with
             JAX's tracking inputs substituted one group at a time; the
             object's pose gap to JAX's solve for each.  `--plain-luma`
             rounds the luma and Sobel sums product by product (the port's
             form before it matched XLA's fused multiply-adds).
gt-pred      tests/test_torch_multimodel.py's GT-mask run: the JAX step at
             frame 5 from JAX's state with one part of the state taken from
             the port's run (poses, maps, carried prediction, previous
             frame); the object's pose against JAX's own step; then the
             carried prediction after one port step from each JAX state.
bench-slot   the bench scene at 320x240 (tests/torch_bench_reference.py):
             the port's run to the frame before `--frame`, then that
             frame's tracking on JAX's inputs in both engines, the port's
             with its normal equations summed in shuffled orders, and
             JAX's with the object's input pose nudged by 1e-7.
"""

import argparse
import dataclasses
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

from cofusion_tpu.config import CameraConfig, CoFusionConfig, FusionParams, TrackingParams  # noqa: E402
from cofusion_tpu.engine import CoFusion as JaxCoFusion  # noqa: E402
from cofusion_tpu.ops import fillin as jfi  # noqa: E402
from cofusion_tpu.ops import odometry as jod  # noqa: E402
from cofusion_tpu.ops import preprocess as jpp  # noqa: E402
from cofusion_tpu_torch import config as tcfg  # noqa: E402
from cofusion_tpu_torch import convert  # noqa: E402
from cofusion_tpu_torch import engine as teng_mod  # noqa: E402
from cofusion_tpu_torch.ops import odometry as tod  # noqa: E402
from cofusion_tpu_torch.ops import preprocess as tpp  # noqa: E402

SMALL = dict(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)


def _jax_track_inputs(state, rgb, depth, cam, cfg, tp, depth_cutoff):
    """The JAX engine's tracking inputs of one CRF-path step (engine.py:
    837-929), jitted as the step computes them."""

    def build(st, rgb, depth):
        models, pred = st.models, st.pred
        intensity = jpp.rgb_to_intensity(rgb)
        filtered = jpp.bilateral_filter(depth, depth_cutoff)
        filled = jfi.fill_in(jax.tree.map(lambda a: a[0], pred), st.prev_rgb, st.prev_filtered, cam,
                             depth_cutoff, passthrough_geom=st.lost, passthrough_rgb=st.lost)
        pv = pred.vert_conf[..., :3].at[0].set(filled.vert)
        pn = pred.normal_rad[..., :3].at[0].set(filled.normal)
        pok = pred.valid.at[0].set(filled.valid)
        pim = pred.image.at[0].set(filled.image)
        fp = jod.build_frame_pyramid(filtered, intensity, None, 0, cam, cfg, depth_cutoff, tp.max_depth_rgb)
        mask_pyrs = [st.prev_mask]
        for _ in range(cfg.pyramid_levels - 1):
            mask_pyrs.append(jpp.pyr_down_nearest(mask_pyrs[-1]))
        bounds = jod.mask_window_bounds(mask_pyrs)
        mp = jax.vmap(lambda v, n, o, im, p: jod.build_model_pyramid(
            v, n, o, jpp.rgb_to_intensity(im), p, cam, cfg, tp.max_depth_rgb))(pv, pn, pok, pim, models.pose)
        ids = models.model_id[:, None, None]
        levels = range(cfg.pyramid_levels)
        vb = tuple(fp.valid[lv][None] & (mask_pyrs[lv][None] == ids) for lv in levels)
        rb = tuple(fp.rgb_ok[lv][None] & (bounds[lv][0][None] == ids) & (bounds[lv][1][None] == ids)
                   for lv in levels)
        return fp, mp, vb, rb

    return jax.jit(build)(state, jnp.asarray(rgb), jnp.asarray(depth))


def _port_track_inputs(state_np, frame, tcam, tc, fparams, use_crf=True):
    """The port's tracking inputs of the same step (track_models' arguments)
    and its new state."""
    captured = {}
    track = tod.track_models

    def spy(*a, **k):
        captured["args"] = a
        return track(*a, **k)

    teng_mod.od.track_models = spy
    try:
        new, _ = teng_mod._step(
            convert.state_from_numpy(state_np), torch.from_numpy(frame["rgb"].astype(np.float32)),
            torch.from_numpy(frame["depth"]), torch.zeros(tcam.shape, dtype=torch.int32), fparams,
            cam=tcam, cfg=tc, tparams=tcfg.TrackingParams(), sparams=tcfg.SegmentationParams(),
            use_crf=use_crf,
        )
    finally:
        teng_mod.od.track_models = track
    return captured["args"], new


def _to_torch(tree_type, jtree):
    return tree_type(*(tuple(torch.from_numpy(np.array(v)) for v in field) for field in jtree))


def _fparams(tc, **fusion):
    f = tcfg.FusionParams(**fusion)
    return dict(depth_cutoff=f.depth_cutoff, outlier_coeff=f.outlier_coefficient,
                icp_weight=tcfg.TrackingParams().icp_weight, time_delta=tc.time_delta,
                spawn_offset=f.model_spawn_offset, conf_object=f.confidence_object,
                deactivate_count=f.model_deactivate_count, keep_data=False, weight_multiplier=1.0,
                new_slot=-1, allow_new=False, gt_masks=False)


def _plain_rounding():
    """The luma and Sobel sums rounded product by product."""

    def luma(rgb):
        rgb = rgb.to(torch.float32)
        return torch.floor(rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114)

    def sobel(img):
        a, b = 0.52201, 0.79451
        s = tpp._shifted
        dx = a * (s(img, -1, 1) - s(img, -1, -1)) + b * (s(img, 0, 1) - s(img, 0, -1)) + a * (
            s(img, 1, 1) - s(img, 1, -1))
        dy = a * (s(img, 1, -1) - s(img, -1, -1)) + b * (s(img, 1, 0) - s(img, -1, 0)) + a * (
            s(img, 1, 1) - s(img, -1, 1))
        return torch.trunc(dx), torch.trunc(dy)

    tpp.rgb_to_intensity = luma
    tpp.sobel_gradients = sobel


def crf_inputs(opts):
    import test_torch_crf_engine as crf

    if opts.plain_luma:
        _plain_rounding()
    cam = CameraConfig(**SMALL)
    cfg = CoFusionConfig(camera=cam, max_models=3, max_surfels=1 << 16, superpixel_size=6)
    tcam = tcfg.CameraConfig(**SMALL)
    tc = tcfg.CoFusionConfig(camera=tcam, max_models=3, max_surfels=1 << 16, superpixel_size=6)
    tp, ttp = TrackingParams(), tcfg.TrackingParams()
    frames, _ = crf._teleport_frames(cam)
    jeng = JaxCoFusion(cfg, fusion_params=FusionParams(**crf.FUSION), enable_multi_model=True)
    _, _, states, _ = crf._play(jeng, frames, snapshot=True)
    k = opts.frame
    st = states[k]
    args, _ = _port_track_inputs(st, frames[k], tcam, tc, _fparams(tc, **crf.FUSION))
    poses, fpT, vbT, rbT, mpT, so3 = args[:6]
    fpJ, mpJ, vbJ, rbJ = _jax_track_inputs(jax.tree.map(jnp.asarray, st), frames[k]["rgb"].astype(np.float32),
                                           frames[k]["depth"], cam, cfg, tp, crf.FUSION["depth_cutoff"])
    ref = np.asarray(jax.jit(lambda *a: jod.track_models(*a, cam, cfg, tp, icp_weight=tp.icp_weight))(
        jnp.asarray(st.models.pose), fpJ, vbJ, rbJ, mpJ, jnp.asarray(st.so3_ref)).pose)
    fpJ, mpJ = _to_torch(tod.FramePyramid, fpJ), _to_torch(tod.ModelPyramid, mpJ)
    vbJ = tuple(torch.from_numpy(np.array(v)) for v in vbJ)
    rbJ = tuple(torch.from_numpy(np.array(v)) for v in rbJ)
    for lv in range(cfg.pyramid_levels):
        print(f"level {lv}: intensity differs at {int((fpT.intensity[lv] != fpJ.intensity[lv]).sum())} px, "
              f"the object's predicted intensity at "
              f"{int((mpT.rgb_pack[lv][1, :, 1] != mpJ.rgb_pack[lv][1, :, 1]).sum())}; "
              f"frame normals max |d| {float((fpT.nmap[lv] - fpJ.nmap[lv]).abs().max()):.3g}")

    def mix(a, b, names):
        return type(a)(*[getattr(b, n) if n in names else getattr(a, n) for n in a._fields])

    for label, fp, mp, vb, rb in (
        ("the port's inputs", fpT, mpT, vbT, rbT),
        ("all of JAX's inputs", fpJ, mpJ, vbJ, rbJ),
        ("JAX's model intensity/depth only", fpT, mix(mpT, mpJ, ("rgb_pack",)), vbT, rbT),
        ("JAX's frame intensity and gradients", mix(fpT, fpJ, ("intensity", "didx", "didy")), mpT, vbT, rbT),
        ("JAX's ICP side (vmap, nmap, icp_pack)", mix(fpT, fpJ, ("vmap", "nmap")),
         mix(mpT, mpJ, ("icp_pack",)), vbT, rbT),
    ):
        res = tod.track_models(poses, fp, vb, rb, mp, so3, tcam, tc, ttp, icp_weight=ttp.icp_weight)
        gap = np.abs(res.pose.numpy() - ref).max(axis=(1, 2))
        print(f"frame {k}, {label:40s}: pose gap to JAX's solve per slot {gap}")


def gt_pred(opts):
    import test_torch_multimodel as mm

    cam = CameraConfig(**SMALL)
    from cofusion_tpu.io.synthetic import make_sequence

    jeng, teng = mm._engines(cam, depth_cutoff=4.5, confidence_object=0.01, model_spawn_offset=0)
    frames, _, _ = make_sequence(cam, 8, kind="orbit", moving_object=True)
    calls = mm._record_steps(jeng)
    _, _, js, masks = mm._play(jeng, frames, snapshot=True)
    _, _, ts, _ = mm._play(teng, frames, snapshot=True)
    treedef = jax.tree.structure(jeng.state)
    k = opts.frame
    fn, args = calls[k - 1]

    def run(st):
        new, _ = fn(jax.tree.unflatten(treedef, [jnp.asarray(np.array(a)) for a in jax.tree.leaves(st)]), *args)
        return np.asarray(new.models.pose)

    J, T = js[k], ts[k]
    ref = run(J)
    for label, model_fields, top_fields in (
        ("poses", ("pose", "prev_pose"), ()),
        ("maps (both tiers)", ("store", "stable"), ()),
        ("carried prediction", (), ("pred",)),
        ("previous frame", (), ("prev_rgb", "prev_filtered", "so3_ref")),
        ("the whole state", J.models._fields, tuple(f for f in J._fields if f != "models")),
    ):
        st = J._replace(models=J.models._replace(**{f: getattr(T.models, f) for f in model_fields}))
        st = st._replace(**{f: getattr(T, f) for f in top_fields})
        print(f"frame {k}, JAX's step with the port's {label:20s}: object pose |d| "
              f"{np.abs(run(st)[1] - ref[1]).max():.3e}")
    pose = np.array(J.models.pose)
    pose[1, 0, 3] += 1e-7
    nudged = J._replace(models=J.models._replace(pose=pose))
    print(f"frame {k}, JAX's step with the object's pose nudged by 1e-7: object pose |d| "
          f"{np.abs(run(nudged)[1] - ref[1]).max():.3e}")
    P, Q = J.pred, T.pred
    d = np.abs(np.asarray(P.vert_conf) - np.asarray(Q.vert_conf)).reshape(P.vert_conf.shape[0], -1, 4).max(-1)
    print(f"the carried prediction before frame {k}: pixels differing > 1e-3 per slot {(d > 1e-3).sum(1)}, "
          f"object pixels {int(np.asarray(P.valid)[1].sum())}")
    for step in range(1, k + 1):
        spawned = 1 if step == 1 else -1
        new = mm._one_step(teng, js[step], frames[step], masks[step], spawned)
        d = np.abs(np.asarray(js[step + 1].pred.vert_conf) - new.pred.vert_conf.numpy())
        d = d.reshape(d.shape[0], -1, 4).max(-1)
        print(f"one port step from JAX's state, frame {step}: prediction pixels differing > 1e-3 per slot "
              f"{(d > 1e-3).sum(1)}")


def bench_slot(opts):
    from cofusion_tpu_torch.io.synthetic import make_multi_object_frames
    from torch_bench_reference import FUSION

    full = CameraConfig()
    cam = CameraConfig(width=full.width // 2, height=full.height // 2, fx=full.fx / 2, fy=full.fy / 2,
                       cx=full.cx / 2, cy=full.cy / 2)
    cfg = CoFusionConfig(camera=cam, max_models=4, max_surfels=1 << 22)
    tcam = tcfg.CameraConfig(**dataclasses.asdict(cam))
    tc = tcfg.CoFusionConfig(camera=tcam, max_models=4, max_surfels=1 << 22)
    tp, ttp = TrackingParams(), tcfg.TrackingParams()
    unique = make_multi_object_frames(tcam, 12)
    k = opts.frame
    frames = [dict(unique[i % 12], mask=None, timestamp=i) for i in range(k + 1)]
    teng = teng_mod.CoFusion(tc, fusion_params=tcfg.FusionParams(**FUSION), enable_multi_model=True,
                             device="cpu")
    for f in frames[:k]:
        teng.process_frame(f)
    st = jax.tree.map(lambda a: np.array(a), convert.state_to_numpy(teng.state))
    args, _ = _port_track_inputs(st, frames[k], tcam, tc, _fparams(tc, **FUSION))
    poses, so3 = args[0], args[5]
    fpJ, mpJ, vbJ, rbJ = _jax_track_inputs(jax.tree.map(jnp.asarray, st), frames[k]["rgb"].astype(np.float32),
                                           frames[k]["depth"], cam, cfg, tp, FUSION["depth_cutoff"])
    jtrack = jax.jit(lambda p, *a: jod.track_models(p, *a, cam, cfg, tp, icp_weight=tp.icp_weight))
    jres = jtrack(jnp.asarray(st.models.pose), fpJ, vbJ, rbJ, mpJ, jnp.asarray(st.so3_ref))
    jpose = np.asarray(jres.pose)
    targs = (_to_torch(tod.FramePyramid, fpJ), tuple(torch.from_numpy(np.array(v)) for v in vbJ),
             tuple(torch.from_numpy(np.array(v)) for v in rbJ), _to_torch(tod.ModelPyramid, mpJ), so3)
    res = tod.track_models(poses, *targs, tcam, tc, ttp, icp_weight=ttp.icp_weight)
    base = res.pose.numpy()
    kappa = [float(np.linalg.cond(a)) if np.abs(a).sum() else float("nan") for a in res.A.numpy()]
    print(f"frame {k}: active {st.models.active}; the port on JAX's inputs against JAX: pose |d| per slot "
          f"{np.abs(base - jpose).max(axis=(1, 2))}; ICP correspondences {res.icp_count.numpy()} against "
          f"{np.asarray(jres.icp_count)}; condition per slot {kappa}")
    reduce = tod._reduce_system_b
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)

        def shuffled(rows, found):
            flat, ok = rows.reshape(rows.shape[0], -1, rows.shape[-1]), found.reshape(found.shape[0], -1)
            order = torch.randperm(flat.shape[1], generator=gen)
            return reduce(flat[:, order, None], ok[:, order, None])

        tod._reduce_system_b = shuffled
        try:
            r2 = tod.track_models(poses, *targs, tcam, tc, ttp, icp_weight=ttp.icp_weight)
        finally:
            tod._reduce_system_b = reduce
        print(f"the port, sums shuffled ({seed}): pose |d| per slot {np.abs(r2.pose.numpy() - base).max(axis=(1, 2))}, "
              f"ICP correspondences {r2.icp_count.numpy()}")
    for m in range(1, 4):
        if not st.models.active[m]:
            continue
        for eps in (1e-7, -1e-7):
            p0 = np.array(st.models.pose)
            p0[m, 0, 3] += eps
            rj = jtrack(jnp.asarray(p0), fpJ, vbJ, rbJ, mpJ, jnp.asarray(st.so3_ref))
            print(f"JAX, slot {m}'s pose nudged by {eps:g}: pose |d| per slot "
                  f"{np.abs(np.asarray(rj.pose) - jpose).max(axis=(1, 2))}, ICP correspondences "
                  f"{np.asarray(rj.icp_count)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", choices=("crf-inputs", "gt-pred", "bench-slot"))
    ap.add_argument("--frame", type=int, default=None,
                    help="the step traced (default 7, 5 and 37 for the three traces)")
    ap.add_argument("--plain-luma", action="store_true")
    opts = ap.parse_args(argv)
    torch.set_num_threads(1)
    default = {"crf-inputs": 7, "gt-pred": 5, "bench-slot": 37}[opts.trace]
    opts.frame = default if opts.frame is None else opts.frame
    {"crf-inputs": crf_inputs, "gt-pred": gt_pred, "bench-slot": bench_slot}[opts.trace](opts)


if __name__ == "__main__":
    main()
