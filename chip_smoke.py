#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (cofusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline DIR]

Drives the port's main path — the `-static` frame at 640x480 with the CLI's
default capacity (2^20 surfels, 2^19 active) — through `CoFusion.process_frame`,
after building every hand-written kernel from csrc/ and holding each against
its plain PyTorch version on the card.  Phases (each prints one line of
findings and raises on failure; nothing is caught, nothing falls back to the
CPU):

  1. device       CUDA required; nvidia-smi name/power limit, torch/CUDA versions
  2. build        nvcc build of csrc/*.cu, one nvcc per file, all at once
                  (seconds, ptxas register/smem lines)
  3. kernels      kernel vs plain version, bit for bit, at the main path's
                  shapes and at edge shapes (odd sizes, radii 0/1/8, no valid
                  candidate, extreme splat operands, inf/NaN depth); at the
                  main path's shape the
                  kernel's device ms per launch (torch.profiler over 100
                  launches), the wrapper's wall ms per call (host clock, one
                  synchronise), the plain version's ms per call, and the
                  bound (bytes over 3.35 TB/s against operations over their
                  peak rate); with --baseline DIR, the same device times of
                  the kernels built from the sources in DIR (an earlier
                  csrc/), for a before/after within one run
  4. main path    30-frame synthetic orbit at 640x480; frames 3-30 run under
                  torch.cuda.set_sync_debug_mode("error"); launch counters,
                  ATE, surfel count, first-frame ms, peak memory
  5. timing       the same 30 frames again on a new engine, without the sync
                  check: frames 3-30 timed as one window (host enqueue time
                  and synchronised wall time per frame); poses and map
                  bit-identical to phase 4's run (determinism); then 3 more
                  frames under torch.profiler: kernel launches and device
                  busy ms per frame, and the device's idle share
  6. parity       12-frame 160x128 orbit through the port on the CPU (plain
                  versions) and on the card (kernels): poses within
                  1e-5 + 2e-6*step, surfel counts equal

The last stdout line is {"ok": true, "device": {...}}; before it, a
{"kernels": [...]} line and the nvidia-smi name/power-limit line.  Exits
non-zero without a result when CUDA is unavailable or any phase fails.
Imports only the port (cofusion_tpu_torch), which imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def _phase(tag: str, /, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# published H100 SXM peaks (NVIDIA's data sheet: HBM3, fp32 outside the
# tensor cores; special-function unit: 16 results per clock per SM x 132 SMs
# x 1.98 GHz boost clock) used for each kernel's bound
_HBM_BYTES_PER_S = 3.35e12
_FP32_OPS_PER_S = 67e12
_SFU_OPS_PER_S = 16 * 132 * 1.98e9


def _device_ms(fn, kernel: str, n: int = 100) -> tuple[float, float]:
    """(device ms per launch of the kernels named `kernel`, kernel launches
    of any name per launch of it) over `n` back-to-back calls of `fn`, from
    torch.profiler's key_averages.  The profiler may miss a few launches at
    the start of its window, so both are taken over the records it kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = [e for e in cuda if kernel in e.key]
    count = sum(e.count for e in mine)
    if not 0.9 * n <= count <= n:
        raise RuntimeError(f"profiler kept {count} launches of {kernel} in {n} calls: "
                           f"{[e.key for e in cuda]}")
    device_us = sum(e.self_device_time_total for e in mine)
    if not device_us > 0:
        raise RuntimeError(f"profiler shows no device time for {kernel}")
    return device_us / 1e3 / count, sum(e.count for e in cuda) / count


def _wall_ms(fn, n: int) -> float:
    """Host-clock ms per call over `n` back-to-back calls, one synchronise
    at the end."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _bound(bytes_moved: float, ops: dict) -> tuple[float, str]:
    """Least time in ms for the work: bytes over the memory rate against
    each kind of operation over its peak rate; and which bounds it."""
    t_bytes = bytes_moved / _HBM_BYTES_PER_S
    t_ops = max(n / rate for n, rate in ops.values())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _splat_fixture(B: int, H: int, W: int, r: int, device, valid_share: float = 0.6,
                   extreme: bool = False):
    """The random-disk fixture of tests/test_pallas_splat.py (disks along
    each pixel's ray at random depths, random camera-facing normals and
    radii), laid out as the index map lays it out: position and normal are
    views of (B, H, W, 4) tensors, as splat_from_imap passes them.
    `extreme`: a tenth of the normals scaled by 1e20, a tenth of the
    positions by 1e-30 (operands outside the kernel's branch-free division
    window) and a twentieth of the normals zero (grazing)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    fx = fy = 60.0
    cx, cy = W / 2, H / 2
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    z = rng.uniform(0.5, 3.0, size=(B, H, W)).astype(np.float32)
    vert_conf = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z, np.ones_like(z)], -1)
    nr = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    nr[..., 2] -= 1.5
    nr /= np.linalg.norm(nr, axis=-1, keepdims=True)
    rad = rng.uniform(0.0, 0.2, size=(B, H, W)).astype(np.float32)
    if extreme:
        pick = rng.random((B, H, W))
        nr[pick < 0.1] *= 1e20
        vert_conf[(pick >= 0.1) & (pick < 0.2), :3] *= 1e-30
        nr[(pick >= 0.2) & (pick < 0.25)] = 0.0
    normal_rad = np.concatenate([nr, rad[..., None]], -1)
    valid = rng.random((B, H, W)) < valid_share
    vc = torch.from_numpy(vert_conf.astype(np.float32)).to(device)
    nrad = torch.from_numpy(normal_rad.astype(np.float32)).to(device)
    return (vc[..., :3], nrad[..., :3], nrad[..., 3], torch.from_numpy(valid).to(device), r,
            (fx, fy, cx, cy))


def _splat_bound(args) -> tuple[float, str]:
    """Bound of one window sweep on these inputs: each valid candidate's
    position, normal and radius read once (28 B), every validity byte, and
    best_z/best_tap written (8 B/px); ~26 fp32 ops per ray-disk test of a
    valid in-image candidate, 6 to fold p.n and r^2, 10 for each ray."""
    import torch.nn.functional as F

    valid, r = args[3], args[4]
    n_px = valid.numel()
    n_valid = int(valid.sum())
    k = 2 * r + 1
    n_tests = int(round(float(
        F.avg_pool2d(valid.float()[:, None], k, stride=1, padding=r, count_include_pad=True).sum()
    ) * k * k))
    return _bound(n_valid * 28 + n_px * 9,
                  {"fp32": (n_tests * 26 + n_valid * 6 + n_px * 10, _FP32_OPS_PER_S)})


def _bilateral_bound(d, max_depth: float) -> tuple[float, str]:
    """Bound of one filter on this depth image: 4 B/px read and written; for
    each centre inside [0.3, max_depth], one exp (special-function unit) and
    ~10 fp32 ops per finite in-image tap."""
    import torch
    import torch.nn.functional as F

    centre = ((d >= 0.3) & (d <= max_depth)).float()
    finite = torch.isfinite(d).float()[None, None]
    taps = F.avg_pool2d(finite, 13, stride=1, padding=6, count_include_pad=True)[0, 0] * 169
    n_exp = int(round(float((taps * centre).sum())))
    return _bound(d.numel() * 8, {"sfu": (n_exp, _SFU_OPS_PER_S), "fp32": (n_exp * 10, _FP32_OPS_PER_S)})


def _pack_geometry(cand_pos, cand_norm, cand_rad, cand_valid):
    """The baseline splat kernel's packed (B, 8, H, W) input."""
    import torch

    pdn = (cand_pos[..., 0] * cand_norm[..., 0] + cand_pos[..., 1] * cand_norm[..., 1]
           + cand_pos[..., 2] * cand_norm[..., 2])
    rad2 = torch.where(cand_valid, cand_rad * cand_rad, -1.0)
    return torch.stack([cand_pos[..., 0], cand_pos[..., 1], cand_pos[..., 2],
                        cand_norm[..., 0], cand_norm[..., 1], cand_norm[..., 2], pdn, rad2],
                       dim=1).contiguous()


def _baseline(csrc: str):
    """Build the baseline kernels (an earlier csrc/: the same bilateral entry
    point, a splat that took the packed (B, 8, H, W) image) from the
    directory `csrc` and return launchers for them."""
    import ctypes
    from pathlib import Path

    import torch

    from cofusion_tpu_torch.ops import _build

    P, I, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = _build.build(_build.sources(Path(csrc)), {
        "cofusion_bilateral_f32": (P, P, I, I, F_, P),
        "cofusion_splat_window_f32": (P, P, P, I, I, I, I, F_, F_, F_, F_, P),
    }).lib

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def bilateral(d, max_depth):
        out = torch.empty_like(d)
        _build.check_launch("baseline bilateral", lib.cofusion_bilateral_f32(
            d.data_ptr(), out.data_ptr(), d.shape[0], d.shape[1], float(max_depth), stream()))
        return out

    def splat(geo, r, cam_tup):
        B, _, H, W = geo.shape
        z = torch.empty((B, H, W), device=geo.device)
        tap = torch.empty((B, H, W), dtype=torch.int32, device=geo.device)
        _build.check_launch("baseline splat", lib.cofusion_splat_window_f32(
            geo.data_ptr(), z.data_ptr(), tap.data_ptr(), B, H, W, r,
            *(float(c) for c in cam_tup), stream()))
        return z, tap

    return bilateral, splat


def _timing(name: str, at, fn, plain, kernel: str, bound, baseline=None) -> dict:
    """Time one kernel at one shape and print its line: device ms per launch
    of `kernel` (and of the baseline's kernel, a (fn, kernel name) pair),
    wrapper and plain ms per call, the bound and the share of it."""
    ms, per_call = _device_ms(fn, kernel)
    row = dict(ms=ms, wrapper_ms=_wall_ms(fn, 100), plain_ms=_wall_ms(plain, 5),
               launches_per_call=per_call)
    row["bound_ms"], row["bound_by"] = bound
    if baseline:
        row["baseline_ms"] = _device_ms(*baseline)[0]
    _phase("kernels", kernel=name, at=at, device_ms=f"{ms:.5f}",
           wrapper_ms=f"{row['wrapper_ms']:.5f}", plain_ms=f"{row['plain_ms']:.4f}",
           bound_ms=f"{row['bound_ms']:.5f}", bound_by=row["bound_by"],
           share_of_bound=f"{row['bound_ms'] / ms:.3f}", launches_per_call=per_call,
           baseline_device_ms=f"{row['baseline_ms']:.5f}" if baseline else "not measured")
    if per_call != 1.0:
        raise RuntimeError(f"{name}: {per_call} kernel launches per call, expected 1")
    return row


def _max_err(a, b) -> float:
    """max |a - b| over the entries finite in both (0.0 if there are none)."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def phase_kernels(dev, depth_frame, baseline_csrc=None):
    """Each kernel against its plain version at the main path's shapes and
    at edge shapes (bar: equal bit for bit), then device time per launch
    (torch.profiler, 100 launches), wrapper wall ms per call, plain ms per
    call and the bound at the main path's shape."""
    import numpy as np
    import torch

    from cofusion_tpu_torch.ops import cuda_splat, cuda_stencil

    base = _baseline(baseline_csrc) if baseline_csrc else None
    results = {}

    # --- bilateral: (480, 640) with 10% zero holes; (37, 53); inf/NaN pixels
    rng = np.random.default_rng(0)
    holes = np.where(rng.random(depth_frame.shape) < 0.1, 0.0, depth_frame).astype(np.float32)
    odd = rng.uniform(0.2, 4.0, (37, 53)).astype(np.float32)
    odd[rng.random(odd.shape) < 0.1] = 0.0
    bad = holes.copy()
    for value, share in ((np.inf, 0.02), (np.nan, 0.02), (-np.inf, 0.01)):
        bad[rng.random(bad.shape) < share] = value
    max_err = 0.0
    for tag, arr in (("holes", holes), ("odd", odd), ("inf_nan", bad)):
        d = torch.from_numpy(arr).to(dev)
        out_k = cuda_stencil.bilateral_filter_cuda(d, 4.5)
        out_p = cuda_stencil.bilateral_filter_plain(d, 4.5)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_p)
        n_diff = int((out_k != out_p).sum())
        _phase("kernels", kernel="bilateral", case=tag, shape=tuple(d.shape), max_abs_err=err,
               differing_pixels=n_diff, bar="bit-equal")
        if n_diff:
            raise RuntimeError(f"bilateral kernel differs from plain at {n_diff} pixels of {tag}")
        if base and not torch.equal(base[0](d, 4.5), out_p):
            raise RuntimeError(f"baseline bilateral differs from plain on {tag}")
        max_err = max(max_err, err)
    d = torch.from_numpy(holes).to(dev)
    row = _timing("bilateral", tuple(d.shape), lambda: cuda_stencil.bilateral_filter_cuda(d, 4.5),
                  lambda: cuda_stencil.bilateral_filter_plain(d, 4.5), "bilateral_tile_kernel",
                  _bilateral_bound(d, 4.5),
                  (lambda: base[0](d, 4.5), "bilateral_kernel") if base else None)
    results["bilateral_filter"] = dict(max_abs_err=max_err, **row, library_ms=None)

    # --- window splat: taps and z bit-equal at every shape
    splat_err = 0.0
    cases = [((1, 480, 640), 3, 0.6, False), ((4, 480, 640), 3, 0.6, False),
             ((2, 37, 53), 0, 0.6, False), ((2, 37, 53), 1, 0.6, False),
             ((2, 37, 53), 8, 0.6, False), ((1, 480, 640), 3, 0.0, False),
             ((2, 96, 128), 3, 0.6, True)]
    timed = {}
    for shape, r, share, extreme in cases:
        args = _splat_fixture(*shape, r, dev, valid_share=share, extreme=extreme)
        z_k, tap_k = cuda_splat.splat_window_cuda(*args)
        z_p, tap_p = cuda_splat.splat_window_plain(*args)
        torch.cuda.synchronize()
        hit = float((tap_p >= 0).float().mean())
        if share and hit < 0.3:
            raise RuntimeError(f"splat fixture {shape} r={r}: too few hits to be meaningful")
        n_mism = int((tap_k != tap_p).sum())
        zerr = _max_err(z_k, z_p)
        _phase("kernels", kernel="splat_window", shape=shape, r=r, valid_share=share,
               extreme_values=extreme, tap_mismatches=n_mism, max_abs_z_err=zerr, hit_fraction=f"{hit:.3f}", bar="bit-equal")
        if n_mism or not torch.equal(z_k, z_p):
            raise RuntimeError(f"splat kernel differs from plain on {shape} r={r}: "
                               f"{n_mism} taps, max |z err| {zerr}")
        if base:
            zb, tb = base[1](_pack_geometry(*args[:4]), r, args[5])
            if not (torch.equal(zb, z_p) and torch.equal(tb, tap_p)):
                raise RuntimeError(f"baseline splat differs from plain on {shape} r={r}")
        splat_err = max(splat_err, zerr)
        if r == 3 and share and not extreme:
            geo = _pack_geometry(*args[:4]) if base else None
            timed[shape] = _timing(
                "splat_window", f"{shape} r={r}", lambda: cuda_splat.splat_window_cuda(*args),
                lambda: cuda_splat.splat_window_plain(*args), "splat_window_fused_kernel",
                _splat_bound(args),
                (lambda: base[1](geo, r, args[5]), "splat_window_kernel") if base else None)
    results["splat_window"] = dict(max_abs_err=splat_err, **timed[(1, 480, 640)], library_ms=None)
    return results


def _engine(dev):
    from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams
    from cofusion_tpu_torch.engine import CoFusion

    cfg = CoFusionConfig(camera=CameraConfig(), max_models=1)
    return CoFusion(cfg, fusion_params=FusionParams(depth_cutoff=4.5), device=dev)


def phase_main_path(dev, frames, gt):
    import numpy as np
    import torch

    from cofusion_tpu_torch.ops import cuda_splat, cuda_stencil
    from cofusion_tpu_torch.utils.export import ate_rmse

    eng = _engine(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_stencil.bilateral_filter_cuda.launches = 0
    cuda_splat.splat_window_cuda.launches = 0

    t0 = time.perf_counter()
    eng.process_frame(frames[0])
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    eng.process_frame(frames[1])
    torch.cuda.synchronize()
    # frames 3..30: any hidden host sync in the step raises; timed as one
    # window so phase 5 shows what the check costs
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in frames[2:]:
            eng.process_frame(f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    checked_ms = (time.perf_counter() - t0) * 1e3 / len(frames[2:])
    launches = {
        "bilateral_filter": cuda_stencil.bilateral_filter_cuda.launches,
        "splat_window": cuda_splat.splat_window_cuda.launches,
    }
    peak = torch.cuda.max_memory_allocated()
    est = [p[1][0] for p in eng.pose_log]
    ate12 = ate_rmse(est[:12], gt[:12], align=False)
    ate30 = ate_rmse(est, gt, align=False)
    n = eng.surfel_count(0)
    n_px = eng.cam.width * eng.cam.height
    _phase("main_path", frames=len(frames), launches=launches, ate12_m=f"{ate12:.6f}",
           ate30_m=f"{ate30:.6f}", surfels=n, surfels_per_pixel=f"{n / n_px:.3f}",
           first_frame_ms=f"{first_ms:.3f}", max_memory_allocated_bytes=peak,
           sync_debug="error on frames 3-30", checked_ms_per_frame=f"{checked_ms:.3f}")
    if launches["bilateral_filter"] < len(frames) or launches["splat_window"] < len(frames):
        raise RuntimeError(f"main path did not go through both kernels: {launches}")
    if not ate12 < 0.003:
        raise RuntimeError(f"ATE over the first 12 frames {ate12:.6f} m >= 3 mm")
    if not 0.3 * n_px < n < 3.0 * n_px:
        raise RuntimeError(f"surfel count {n} outside 0.3-3x the pixel count {n_px}")
    if not all(np.isfinite(p).all() for p in est):
        raise RuntimeError("non-finite pose in the main path")
    return launches, eng


def phase_timing(dev, frames, ref_eng):
    """Phase 4's frames on a new engine with no sync check and no per-frame
    synchronize: frames 3..N are one timed window.  The rerun must equal
    phase 4's run bit for bit."""
    import numpy as np
    import torch

    eng = _engine(dev)
    eng.process_frame(frames[0])
    eng.process_frame(frames[1])
    torch.cuda.synchronize()
    window = frames[2:]
    enqueue_s = 0.0
    t0 = time.perf_counter()
    for f in window:
        t = time.perf_counter()
        eng.process_frame(f)
        enqueue_s += time.perf_counter() - t
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    _phase("timing", frames=f"3-{len(frames)}",
           steady_ms_per_frame=f"{wall_s * 1e3 / len(window):.3f}",
           host_enqueue_ms_per_frame=f"{enqueue_s * 1e3 / len(window):.3f}",
           method="one synchronised window, no sync check")

    for i, (a, b) in enumerate(zip(eng.pose_log, ref_eng.pose_log)):
        if not np.array_equal(a[1], b[1]):
            raise RuntimeError(f"rerun pose {i} differs: max {np.abs(a[1] - b[1]).max()}")
    st, ref = eng.state.models, ref_eng.state.models
    for tier in ("store", "stable"):
        for name, a, b in zip(st.store._fields, getattr(st, tier), getattr(ref, tier)):
            if not torch.equal(a, b):
                raise RuntimeError(f"rerun map field {tier}.{name} differs")
    _phase("determinism", frames=len(frames), poses="bit-identical", store="bit-identical",
           active_count=int(st.store.count[0]), stable_count=int(st.stable.count[0]))

    # where the time goes: launches and device busy time over 3 more frames
    # (the last frames fed again); idle share against the unprofiled window
    from torch.profiler import ProfilerActivity, profile

    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in frames[-n:]:
            eng.process_frame(f)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    busy_ms = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    ) / 1e3 / n
    steady_ms = wall_s * 1e3 / len(window)
    _phase("profile", frames=n, kernel_launches_per_frame=launches / n,
           device_busy_ms_per_frame=f"{busy_ms:.3f}" if busy_ms else "not measured",
           device_idle_share=f"{1.0 - busy_ms / steady_ms:.3f}" if busy_ms else "not measured")


def _run_small(device, frames):
    from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams
    from cofusion_tpu_torch.engine import CoFusion

    cam = CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
    cfg = CoFusionConfig(camera=cam, max_models=1, max_surfels=1 << 17)
    eng = CoFusion(cfg, fusion_params=FusionParams(depth_cutoff=4.5), device=device)
    counts = []
    for f in frames:
        eng.process_frame(f)
        counts.append(int(eng.stats()["surfel_counts"][0]))
    return [p[1][0] for p in eng.pose_log], counts


def phase_parity():
    import numpy as np

    from cofusion_tpu_torch.config import CameraConfig
    from cofusion_tpu_torch.io.synthetic import make_sequence

    cam = CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
    frames, _ = make_sequence(cam, 12)
    cpu_poses, cpu_counts = _run_small("cpu", frames)
    gpu_poses, gpu_counts = _run_small("cuda", frames)
    worst = 0.0
    for step, (a, b) in enumerate(zip(cpu_poses, gpu_poses)):
        d = float(np.abs(a - b).max())
        worst = max(worst, d)
        if d > 1e-5 + 2e-6 * step:
            raise RuntimeError(f"CPU/card pose parity broken at step {step}: {d}")
    _phase("parity", frames=12, camera="160x128", max_pose_diff=worst,
           bar="1e-5+2e-6*step", cpu_counts=cpu_counts[-1], card_counts=gpu_counts[-1])
    if cpu_counts != gpu_counts:
        raise RuntimeError(f"CPU/card surfel counts differ: {cpu_counts} vs {gpu_counts}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="also time the kernels built from the .cu files in DIR")
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from cofusion_tpu_torch.config import CameraConfig
    from cofusion_tpu_torch.device import resolve_device
    from cofusion_tpu_torch.io.synthetic import make_sequence
    from cofusion_tpu_torch.ops import _build

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    dev = resolve_device("cuda")
    smi = _nvidia_smi()
    _phase("device", nvidia_smi=repr(smi), name=repr(torch.cuda.get_device_name(0)),
           count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    lib = _build.load()
    ptxas = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln or "bytes smem" in ln]
    _phase("build", seconds=f"{lib.seconds:.2f}", built=lib.built, library=os.path.relpath(lib.path, REPO))
    for ln in ptxas:
        print("  ptxas: " + ln)

    t0 = time.perf_counter()
    frames, gt = make_sequence(CameraConfig(), 30)
    _phase("frames", n=len(frames), shape=frames[0]["depth"].shape,
           seconds=f"{time.perf_counter() - t0:.1f}")

    kern = phase_kernels(dev, frames[0]["depth"], opts.baseline)
    launches, eng = phase_main_path(dev, frames, gt)
    phase_timing(dev, frames, eng)
    del eng
    phase_parity()

    sources = {
        "bilateral_filter": ("cofusion_tpu_torch/csrc/bilateral.cu", "cofusion_tpu/ops/pallas_stencil.py:75"),
        "splat_window": ("cofusion_tpu_torch/csrc/splat_window.cu", "cofusion_tpu/ops/pallas_splat.py:116"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **kern[name]}
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
