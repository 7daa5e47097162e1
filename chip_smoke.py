#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (cofusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the `-static` frame at 640x480 with the CLI's
default capacity (2^20 surfels, 2^19 active) — through `CoFusion.process_frame`,
after building every hand-written kernel from csrc/ and holding each against
its plain PyTorch version on the card.  Phases (each prints one line of
findings and raises on failure; nothing is caught, nothing falls back to the
CPU):

  1. device       CUDA required; nvidia-smi name/power limit, torch/CUDA versions
  2. build        nvcc build of csrc/*.cu (seconds, ptxas register/smem lines)
  3. kernels      kernel vs plain version at the main path's shapes, with
                  median CUDA-event times of both
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

import json
import os
import statistics
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


def _median_ms(fn, *, warmup: int = 5, iters: int = 50) -> float:
    """Median per-call device time over `iters` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _splat_fixture(B: int, H: int, W: int, device):
    """The random-disk fixture of tests/test_pallas_splat.py: disks along each
    pixel's ray at random depths, random camera-facing normals and radii."""
    import numpy as np
    import torch

    from cofusion_tpu_torch.config import CameraConfig

    cam = CameraConfig(width=W, height=H, fx=60.0, fy=60.0, cx=W / 2, cy=H / 2)
    rng = np.random.default_rng(7)
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    z = rng.uniform(0.5, 3.0, size=(B, H, W)).astype(np.float32)
    px = (u - cam.cx) / cam.fx * z
    py = (v - cam.cy) / cam.fy * z
    nr = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    nr[..., 2] -= 1.5
    nr /= np.linalg.norm(nr, axis=-1, keepdims=True)
    rad = rng.uniform(0.0, 0.2, size=(B, H, W)).astype(np.float32)
    valid = rng.random((B, H, W)) < 0.6
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (t(np.stack([px, py, z], axis=-1)), t(nr), t(rad), t(valid), 3,
            (cam.fx, cam.fy, cam.cx, cam.cy))


def phase_kernels(dev, depth_frame):
    import numpy as np
    import torch

    from cofusion_tpu_torch.ops import cuda_splat, cuda_stencil

    results = {}
    # --- bilateral at 480x640 with zero holes, max_depth 4.5
    rng = np.random.default_rng(0)
    depth = np.where(rng.random(depth_frame.shape) < 0.1, 0.0, depth_frame).astype(np.float32)
    d = torch.from_numpy(depth).to(dev)
    out_k = cuda_stencil.bilateral_filter_cuda(d, 4.5)
    out_p = cuda_stencil.bilateral_filter_plain(d, 4.5)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs()
    tol = 1e-6 + 1e-5 * out_p.abs()
    bad = int((err > tol).sum())
    max_err = float(err.max())
    if bad:
        raise RuntimeError(f"bilateral kernel disagrees with plain at {bad} pixels (max |err| {max_err})")
    ms_k = _median_ms(lambda: cuda_stencil.bilateral_filter_cuda(d, 4.5))
    ms_p = _median_ms(lambda: cuda_stencil.bilateral_filter_plain(d, 4.5))
    _phase("kernels", kernel="bilateral", shape=tuple(d.shape), max_abs_err=max_err,
           bar="rtol=1e-5,atol=1e-6", ms=f"{ms_k:.4f}", plain_ms=f"{ms_p:.4f}")
    results["bilateral_filter"] = dict(max_abs_err=max_err, ms=ms_k, plain_ms=ms_p)

    # --- window splat: taps exact, z within rtol 1e-4 / atol 1e-5
    splat_err = 0.0
    timing = None
    for shape in ((1, 480, 640), (2, 48, 64)):
        args = _splat_fixture(*shape, dev)
        z_k, tap_k = cuda_splat.splat_window_cuda(*args)
        z_p, tap_p = cuda_splat.splat_window_plain(*args)
        torch.cuda.synchronize()
        hit = tap_p >= 0
        if float(hit.float().mean()) < 0.3:
            raise RuntimeError(f"splat fixture {shape}: too few hits to be meaningful")
        mism = tap_k != tap_p
        n_mism = int(mism.sum())
        if n_mism:
            idx = mism.nonzero()[:10].tolist()
            edge = True
            for b, y, x in idx:
                zk, zp = float(z_k[b, y, x]), float(z_p[b, y, x])
                print(f"  tap mismatch {shape} at (b={b}, y={y}, x={x}): kernel z={zk!r} "
                      f"tap={int(tap_k[b, y, x])}, plain z={zp!r} tap={int(tap_p[b, y, x])}")
                frac = [abs(z * 4096.0 - round(z * 4096.0)) for z in (zk, zp)]
                edge = edge and min(frac) < 1e-3
            if not edge or n_mism > len(idx):
                raise RuntimeError(f"splat kernel tap mismatch at {n_mism} pixels of {shape}")
            print(f"  {n_mism} tap mismatches of {shape} all sit at a 1/4096 bucket edge")
        both = hit & (tap_k >= 0)
        zerr = (z_k[both] - z_p[both]).abs()
        ztol = 1e-5 + 1e-4 * z_p[both].abs()
        if bool((zerr > ztol).any()):
            raise RuntimeError(f"splat kernel z outside rtol 1e-4/atol 1e-5 on {shape}")
        splat_err = max(splat_err, float(zerr.max()))
        if shape[0] == 1:
            ms_k = _median_ms(lambda: cuda_splat.splat_window_cuda(*args))
            ms_p = _median_ms(lambda: cuda_splat.splat_window_plain(*args))
            timing = (ms_k, ms_p)
        _phase("kernels", kernel="splat_window", shape=shape, tap_mismatches=n_mism,
               max_abs_z_err=float(zerr.max()), hit_fraction=f"{float(hit.float().mean()):.3f}")
    _phase("kernels", kernel="splat_window", ms=f"{timing[0]:.4f}", plain_ms=f"{timing[1]:.4f}",
           at="(1,480,640) r=3")
    results["splat_window"] = dict(max_abs_err=splat_err, ms=timing[0], plain_ms=timing[1])
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


def main() -> int:
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

    kern = phase_kernels(dev, frames[0]["depth"])
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
