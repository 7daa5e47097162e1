#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (cofusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline DIR] [--only GROUPS]

Drives the port's paths through `CoFusion.process_frame`, after building
every hand-written kernel from csrc/ and holding each against its plain
PyTorch version on the card: the `-static` frame at 640x480 with the CLI's
default capacity (2^20 surfels, 2^19 active), the multi-model path at the
JAX package's bench workload (640x480, 4 model slots, 2^22 surfels a slot,
CRF motion segmentation of 3 moving boxes, bench.py:60-99,124-127), and
`-static -rl -cl` (fern relocalisation, local loop closure and the
deformation graph at 256 nodes) at 640x480; then the remaining surfaces:
'-p' ground-truth poses, `render_views` (the '-en'/'-ev' exports),
checkpoints and hot tuning; the CLI itself over files on disk, scored by
the port's own tools; and last the static, bench and `-rl -cl` paths, the
drift and blackout scenarios and `render_views` on an engine state
sharded over a 4-device mesh.
Phases (each prints one line of findings and raises on failure; nothing is
caught, nothing falls back to the CPU):

  1. device       CUDA required; nvidia-smi name/power limit, torch/CUDA versions
  2. build        nvcc build of csrc/*.cu, one nvcc per file, all at once
                  (seconds, ptxas register/smem lines)
  3. kernels      kernel vs plain version, bit for bit, at the main paths'
                  shapes (splat at B = 1 and B = 4) and at edge shapes (odd
                  sizes, radii 0/1/8, no valid candidate, extreme splat
                  operands, inf/NaN depth); at the main paths' shapes the
                  kernel's device ms per launch (torch.profiler over 100
                  launches), the wrapper's wall ms per call (host clock, one
                  synchronise), the plain version's ms per call, and the
                  bound (bytes over 3.35 TB/s against operations over their
                  peak rate); with --baseline DIR, the same device times of
                  the kernels built from the sources in DIR (an earlier
                  csrc/), for a before/after within one run
  4. main path    30-frame synthetic orbit at 640x480, `-static`; frames
                  3-30 run under torch.cuda.set_sync_debug_mode("error");
                  launch counters, ATE, surfel count, first-frame ms, peak
                  memory
  5. timing       the same 30 frames again on a new engine, without the sync
                  check: frames 3-30 timed as one window (host enqueue time
                  and synchronised wall time per frame); poses and map
                  bit-identical to phase 4's run (determinism); then 1 more
                  frame under torch.profiler: kernel launches and device
                  busy ms per frame, and the device's idle share
  6. parity       12-frame 160x128 orbit through the port on the CPU (plain
                  versions) and on the card (kernels), held as phase 9
                  holds its runs
  7. multi CRF    the bench workload: make_multi_object_frames(cam, 12)
                  played for 40 frames through the CRF path, frames 3-40
                  under the sync check; both launch counters equal to the
                  frame count; spawns, lifecycle events and active slots:
                  an object slot active at the end and at least 10 frames
                  after the first spawn; per-object IoU against the
                  renderer's masks on the last 2 frames (reported, not
                  gated: ROADMAP C1); finite poses, peak memory,
                  first-frame ms; then phase 5's rerun (bit for bit: poses,
                  maps, masks) with the frames after the first spawn as the
                  timing window, and the 1-frame profile; and the device ms
                  of one object slot's fuse/clean, which an idle slot pays
                  as well (the idle-slot select)
  8. GT masks     12 frames of the same scene with its object masks
                  (spawn offset 2): the 3 objects spawn at the frames the
                  host mirror of the spawn cooldown predicts; finite object
                  pose logs
  9. multi parity CPU against card at 160x128, max_models=3: the GT-mask
                  sequence of tests/test_multimodel.py and the teleport
                  scenario of tests/test_crf_engine.py.  On every frame:
                  the card's step from the CPU run's state within 1e-5 of
                  the CPU's, counts, active flags and mask equal; camera
                  poses within 1e-5 + 2e-6*step and active flags equal;
                  all poses within that bar plus the CPU's own response to
                  the card's state (the CPU's step from it), counts and
                  masks equal wherever that step keeps the CPU run's
                  (ROADMAP C8); on the card the teleported object spawns
                  with settled IoU > 0.6
 10. loop path    20 orbit frames through `-static -rl -cl` (depth cutoff
                  4.5), frames 3-20 under the sync check: the bilateral
                  kernel once a frame, the splat 4 times (the prediction,
                  the loop block's active view and both tiers' inactive
                  views); ATE, keyframes, peak memory; then phase 5's rerun
                  and profile on it (`[loop_timing]`, `[determinism]`,
                  `[profile]`), and `[loop_blocks]`: device ms, launches and
                  extra memory of the reloc block, the always-computed loop
                  block and its graph solve, by torch.profiler over 2
                  calls on copies of the final state
 11. loop closure tests/test_local_loop.py's drift scenario at 640x480 (map
                  aged out of the window, camera drifted (3, 1.5, 0) cm):
                  a closure fires and the camera error ends below half the
                  run's without '-cl'; the splat kernel bit-equal to its
                  plain version on that state's own index maps
 12. reloc        tests/test_reloc.py's blackout scenario at 640x480: lost
                  during the blackout, >= 1 keyframe, recovered within 3 cm
 13. loop parity  CPU against card as phase 9 for the drift run (80x64)
                  and the blackout run (160x128): lost, loop-closed and
                  keyframe count on every frame, the final keyframe codes
                  exact; where one step's counts part, both devices step
                  again with about an ulp of depth noise and the ranges of
                  their counts must overlap (ROADMAP C11)
 14. gt pose      '-p': phase 4's 30 orbit frames fed their ground-truth
                  poses, frames 3-30 under the sync check; logged poses
                  equal to the given ones; the bilateral kernel once a
                  frame, the splat in the first frame only; surfels, peak
                  memory, then phase 5's rerun and profile; the same on the
                  multi path's GT-mask frames with 4 slots (12 frames)
 15. render views `render_views` ('-en'/'-ev') on phase 4's final state and
                  on the same frames run with time delta 5 (the stable tier
                  fills): the splat kernel bit-equal to its plain version on
                  both tiers' own index maps, valid pixels of each, launches
                  and device ms per call
 16. checkpoint   save at frame 15 of the static orbit, resume in a new
                  engine, run to 30: bit-identical to the uninterrupted
                  run; the file loads on the CPU with an equal state; save
                  and load seconds, file size
 17. hot params   set_params and set_confidence_threshold between frames
                  of the static path (160x128) under the sync check: the
                  run parts from an untouched one from that frame on, and
                  stays within 1e-5 + 2e-6*step of the CPU given the same
                  calls
 18. cli          the dataset-to-score path, with cv2 and matplotlib
                  unimportable: phase 7's 40 frames written as a 640x480
                  PNG directory by the port's own writers (16-bit depth,
                  object ids in a sibling directory), run through
                  `cofusion_tpu_torch.cli.run` (what `python -m
                  cofusion_tpu_torch` calls; CRF mode, -ep -es -em),
                  scored by `cofusion_tpu_torch.tools.evaluate` (ATE,
                  IoU) and viewed by `tools.view --no-png`: spawns,
                  models exported, PNG decode ms and wall ms per frame,
                  both kernels' launches (bilateral once a frame, splat at
                  least once a frame after the first); then `-static -l`
                  over a raw-RGB .klg of phase 4's frames (ATE < 1 cm)
 19. sharded      the engine state sharded over a 4-device mesh
                  (`cofusion_tpu_torch.parallel`: both tiers' surfel axes,
                  virtual on one card), each run against the unsharded run
                  of the same call: phase 4's first 16 frames and the bench
                  workload's first 26 (its first spawn, then 6 more), each
                  run's last frame at time delta 0; phase 10's `-static -rl
                  -cl` 20 frames; phase 11's drift at time delta 3 (the
                  stable tier fills, a closure fires with stable surfels);
                  phase 12's blackout (lost, recovered); `render_views` on
                  phase 15's '-t 5' map.  Poses, both tiers, counts, flags,
                  the fern database, the rings, events, masks and views
                  bit-identical; the kernels' launches as unsharded; the
                  splat bit-equal to its plain version on the sharded
                  step's own combined index maps, the sharded loop block's
                  and `render_views`'; kernel launches and device busy ms of
                  1 more frame, steady ms per frame and each run's own peak
                  memory (frame 1 with the sharding's copy, and the frames
                  after), and the loop block's device ms and peak memory,
                  sharded and unsharded

Each phase line ends with `at_s`, the seconds since the start.  The last
stdout line is {"ok": true, "device": {...}}; before it, a
{"kernels": [...]} line (`launches` from the `-static -rl -cl` path's run,
`launches_multi` and `launches_static` from phases 7 and 4,
`launches_gt_pose` from phase 14's static run, `launches_render` from one
`render_views` call, `launches_cli` from phase 18's CRF run,
`launches_sharded`, `launches_sharded_loop` and `launches_sharded_render`
from phase 19's sharded bench run, `-rl -cl` run and `render_views` call) and the
nvidia-smi name/power-limit line.  Exits non-zero without a result when CUDA is
unavailable or any phase fails.  Imports only the port (cofusion_tpu_torch),
which imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
_T0 = time.perf_counter()


def _phase(tag: str, /, **fields) -> None:
    """One line of findings, ending with the seconds since the start."""
    fields["at_s"] = f"{time.perf_counter() - _T0:.1f}"
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


def _zero_counts():
    """Every kernel wrapper's launch count set to 0."""
    from cofusion_tpu_torch.ops import cuda_splat, cuda_stencil

    cuda_stencil.bilateral_filter_cuda.launches = 0
    cuda_splat.splat_window_cuda.launches = 0


def _read_counts() -> dict:
    """Each kernel's launches since `_zero_counts`."""
    from cofusion_tpu_torch.ops import cuda_splat, cuda_stencil

    return {"bilateral_filter": cuda_stencil.bilateral_filter_cuda.launches,
            "splat_window": cuda_splat.splat_window_cuda.launches}


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
    # the multi-model path's shape (4 slots) in the JSON line; the static
    # path's (B = 1) beside it
    results["splat_window"] = dict(max_abs_err=splat_err, **timed[(4, 480, 640)], library_ms=None,
                                   static_shape_ms=timed[(1, 480, 640)]["ms"])
    return results


def _engine(dev):
    from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams
    from cofusion_tpu_torch.engine import CoFusion

    cfg = CoFusionConfig(camera=CameraConfig(), max_models=1)
    return CoFusion(cfg, fusion_params=FusionParams(depth_cutoff=4.5), device=dev)


def phase_main_path(dev, frames, gt):
    import numpy as np
    import torch

    from cofusion_tpu_torch.utils.export import ate_rmse

    eng = _engine(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()

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
    launches = _read_counts()
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


def phase_timing(make_engine, frames, ref_eng, ref_masks=None, tag="timing", start=2, gt=None):
    """The frames of a main-path phase on a new engine with no sync check
    and no per-frame synchronize: frames start+1..N are one timed window.
    The rerun must equal the reference run bit for bit (poses, both map
    tiers of every slot, and the drained masks when `ref_masks` is given).
    `gt`: each frame's ground-truth pose ('-p').
    Returns (steady ms per frame, device busy ms per frame, the engine)."""
    import numpy as np
    import torch

    def feed(eng, i, f):
        eng.process_frame(f, gt_pose=None if gt is None else gt[i])

    eng = make_engine()
    for i, f in enumerate(frames[:start]):
        feed(eng, i, f)
    torch.cuda.synchronize()
    window = frames[start:]
    enqueue_s = 0.0
    t0 = time.perf_counter()
    for i, f in enumerate(window, start=start):
        t = time.perf_counter()
        feed(eng, i, f)
        enqueue_s += time.perf_counter() - t
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    steady_ms = wall_s * 1e3 / len(window)
    _phase(tag, frames=f"{start + 1}-{len(frames)}", steady_ms_per_frame=f"{steady_ms:.3f}",
           host_enqueue_ms_per_frame=f"{enqueue_s * 1e3 / len(window):.3f}",
           method="one synchronised window, no sync check")

    for i, (a, b) in enumerate(zip(eng.pose_log, ref_eng.pose_log)):
        if not np.array_equal(a[1], b[1]):
            raise RuntimeError(f"{tag} rerun pose {i} differs: max {np.abs(a[1] - b[1]).max()}")
    st, ref = eng.state.models, ref_eng.state.models
    for tier in ("store", "stable"):
        for name, a, b in zip(st.store._fields, getattr(st, tier), getattr(ref, tier)):
            if not torch.equal(a, b):
                raise RuntimeError(f"{tag} rerun map field {tier}.{name} differs")
    if not torch.equal(st.active, ref.active):
        raise RuntimeError(f"{tag} rerun active flags differ")
    if ref_masks is not None:
        masks = dict(eng.drain_segmentation(flush=True))
        if masks.keys() != ref_masks.keys() or any(
            not np.array_equal(masks[t], ref_masks[t]) for t in masks
        ):
            raise RuntimeError(f"{tag} rerun segmentation masks differ")
    _phase("determinism", path=tag, frames=len(frames), poses="bit-identical", store="bit-identical",
           masks="bit-identical" if ref_masks is not None else "not compared",
           active_count=st.store.count.tolist(), stable_count=st.stable.count.tolist())

    # where the time goes: launches and device busy time over 1 more frame
    # (the last frame fed again; the profiler's own processing of a frame's
    # ~10^4 launches takes ~10-25 s); idle share against the unprofiled window
    from torch.profiler import ProfilerActivity, profile

    n = 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(len(frames) - n, len(frames)):
            feed(eng, i, frames[i])
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    busy_ms = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    ) / 1e3 / n
    _phase("profile", path=tag, frames=n, kernel_launches_per_frame=launches / n,
           device_busy_ms_per_frame=f"{busy_ms:.3f}" if busy_ms else "not measured",
           device_idle_share=f"{1.0 - busy_ms / steady_ms:.3f}" if busy_ms else "not measured")
    return steady_ms, busy_ms, eng


# --- the multi-model path (bench.py:88-99,124-127)
MULTI_FRAMES = 40  # bench.py's 12-frame ping-pong cycle, replayed
MULTI_FUSION = dict(depth_cutoff=4.5, confidence_object=0.01, confidence_global=1.5,
                    model_spawn_offset=4, model_deactivate_count=3)


def _multi_engine(dev, **fusion):
    from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams
    from cofusion_tpu_torch.engine import CoFusion

    cfg = CoFusionConfig(camera=CameraConfig(), max_models=4, max_surfels=1 << 22)
    return CoFusion(cfg, fusion_params=FusionParams(**dict(MULTI_FUSION, **fusion)),
                    enable_multi_model=True, device=dev)


def _listen(eng):
    """Lifecycle events as (frames seen when the event fired, kind, slot)."""
    events = []
    eng.add_new_model_listener(lambda s: events.append((len(eng._timestamps), "new", s)))
    eng.add_inactive_model_listener(lambda s: events.append((len(eng._timestamps), "inactive", s)))
    return events


def _iou(a, b) -> float:
    import numpy as np

    union = float(np.logical_or(a, b).sum())
    return float(np.logical_and(a, b).sum()) / union if union else 0.0


# the bench workload's run must spawn, and its timing window (the frames
# after the first spawn) must hold at least this many frames
MIN_OBJECT_FRAMES = 10


def phase_multi_crf(dev, frames, gt_ids):
    """The bench workload through the CRF path: frames 3..N under the sync
    check, both kernels once per frame, lifecycle and segmentation read
    back after the run.  An object slot must be active at the end, and the
    frames after the first spawn (found from the slots' ages) must number
    at least MIN_OBJECT_FRAMES; returns that spawn's frame index too."""
    import numpy as np
    import torch

    eng = _multi_engine(dev)
    events = _listen(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    eng.process_frame(frames[0])
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    eng.process_frame(frames[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in frames[2:]:
            eng.process_frame(f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    checked_ms = (time.perf_counter() - t0) * 1e3 / len(frames[2:])
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    eng.flush_lifecycle()
    masks = dict(eng.drain_segmentation(flush=True))
    log = eng.pose_log
    finite = all(np.isfinite(p).all() for _, p in log)
    active = eng.stats()["active"]
    n = len(frames)
    # a slot's age counts the frames it has been active since its spawn
    age = eng.state.models.age.cpu().numpy()
    spawned_at = {m: n - int(age[m]) for m in range(1, len(active)) if active[m]}
    first_spawn = min(spawned_at.values(), default=n)
    # per object: the best IoU of any object slot against the renderer's
    # mask of that object, on the last 2 frames (frame i -> tick i + 1)
    ious = {
        i: [round(max(_iou(masks[i + 1] == s, gt_ids[i % len(gt_ids)] == obj) for s in range(1, 4)), 4)
            for obj in (1, 2, 3)]
        for i in (n - 2, n - 1)
    }
    _phase("multi_crf", frames=n, launches=launches, events=events,
           active_at_end=active.astype(int).tolist(), spawn_frame_of_active_slot=spawned_at,
           object_slot_frames=int(age[1:].sum()), frames_after_first_spawn=n - 1 - first_spawn, surfels=eng.stats()["surfel_counts"].tolist(),
           labels_last=sorted(np.unique(masks[n]).tolist()), iou_per_object_last2=ious,
           iou_gate="reported only (ROADMAP C1)", first_frame_ms=f"{first_ms:.3f}",
           max_memory_allocated_bytes=peak, sync_debug=f"error on frames 3-{n}",
           checked_ms_per_frame=f"{checked_ms:.3f}")
    if launches["bilateral_filter"] != n or launches["splat_window"] != n:
        raise RuntimeError(f"multi-model path: kernel launches {launches}, expected {n} each")
    if not finite:
        raise RuntimeError("non-finite pose in the multi-model path")
    if len(masks) != n - 1:
        raise RuntimeError(f"drained {len(masks)} masks for {n - 1} tracked frames")
    if not spawned_at or n - 1 - first_spawn < MIN_OBJECT_FRAMES:
        raise RuntimeError(f"bench workload: active object slots {spawned_at} leave "
                           f"{n - 1 - first_spawn} frames after the first spawn (< {MIN_OBJECT_FRAMES})")
    return launches, eng, masks, first_spawn


def phase_idle_slot(eng, steady_ms):
    """What the device-side select costs: an object slot computes its whole
    fuse/clean whether it fuses or not.  Device ms of `_fuse_clean_all`
    over the engine's 4 slots against slot 0 alone (CUDA events, 10 calls
    each on copies of the final state); the difference over 3 is one object
    slot's share, paid per idle slot per frame."""
    import torch

    from cofusion_tpu_torch.engine import _fuse_clean_all

    st, cfg, cam = eng.state, eng.cfg, eng.cam
    models = st.models
    depth = st.prev_filtered
    fp = dict(eng._fparams, weight_multiplier=1.0)

    def run(M):
        stores = type(models.store)(*(a[:M].clone() for a in models.store))
        stables = type(models.stable)(*(a[:M].clone() for a in models.stable))
        args = (models.pose[:M], torch.ones(M, device=depth.device), models.model_id[:M],
                models.conf_threshold[:M], models.active[:M] | True, models.max_depth[:M])
        return lambda: _fuse_clean_all(stores, stables, *args, depth, st.prev_filtered, st.prev_rgb,
                                       st.prev_mask if M > 1 else None, cam, cfg, st.tick, fp)

    times = {}
    for M in (cfg.max_models, 1):
        fn = run(M)
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        times[M] = start.elapsed_time(end) / 10
    slot_ms = (times[cfg.max_models] - times[1]) / (cfg.max_models - 1)
    _phase("idle_slot", fuse_clean_ms_4_slots=f"{times[cfg.max_models]:.3f}",
           fuse_clean_ms_slot0=f"{times[1]:.3f}", per_object_slot_ms=f"{slot_ms:.3f}",
           share_of_steady_frame=f"{slot_ms / steady_ms:.3f}",
           method="CUDA events over 10 calls; an idle slot computes and selects back")


def _predicted_spawns(masks, offset: int, n_slots: int):
    """The host mirror's spawns from the object ids alone: one new id per
    frame, the smallest unmapped visible one, into the lowest free slot,
    once `offset` frames have passed since the last spawn."""
    import numpy as np

    mapped, free, cooldown, out = set(), list(range(1, n_slots)), 0, []
    for i, m in enumerate(masks[1:], start=1):
        new = [v for v in np.unique(m).tolist() if v and v not in mapped]
        if new and free and cooldown >= offset:
            mapped.add(new[0])
            out.append((i, "new", free.pop(0)))
            cooldown = 0
        else:
            cooldown += 1
    return out


def phase_gt_masks(dev, frames):
    """The same scene with its object ids as masks (the `-maskdir` path):
    the 3 objects spawn at the predicted frames, and every object's pose
    log is finite."""
    import numpy as np

    offset = 2
    eng = _multi_engine(dev, model_spawn_offset=offset)
    events = _listen(eng)
    for f in frames:
        eng.process_frame(f)
    # GT-mask events fire inside the frame's call: (frame index, kind, slot)
    got = events
    want = _predicted_spawns([f["mask"] for f in frames], offset, eng.cfg.max_models)
    active = eng.stats()["active"]
    logs = {m: eng.pose_log_for(m) for m in range(4) if eng.model_ever_active(m)}
    finite = all(np.isfinite(p[m]).all() for m, log in logs.items() for _, p in log)
    _phase("gt_masks", frames=len(frames), spawn_offset=offset, events=got, predicted=want,
           active_at_end=active.astype(int).tolist(), surfels=eng.stats()["surfel_counts"].tolist(),
           pose_logs_finite=finite)
    if got != want or len(want) != 3:
        raise RuntimeError(f"GT-mask spawns {got}, predicted {want}")
    if not (finite and active.all()):
        raise RuntimeError(f"GT-mask path: finite pose logs {finite}, active {active}")


def _teleport_frames(cam):
    """tests/test_crf_engine.py's scenario: a box warms the map for 6
    frames, then jumps; with the renderer's object masks."""
    import numpy as np

    from cofusion_tpu_torch.io.synthetic import SyntheticScene, camera_trajectory, object_trajectory

    scene = SyntheticScene()
    h = 0.28
    scene.add_moving_box(model_id=1, lo=[-h, -h, -h], hi=[h, h, h])
    base = object_trajectory(1, translation=(0, 0, 0), center=(0.14, -0.32, 1.82),
                             tilt=(0.35, 0.5, 0.0))[0]
    jump = np.eye(4)
    jump[:3, 3] = (0.40, 0.18, 0.0)
    cam_poses = camera_trajectory(10, kind="orbit", scale=0.4)
    frames, gt = [], []
    for i in range(10):
        rgb, depth, mask = scene.render(cam, cam_poses[i], object_poses={1: base if i < 6 else jump @ base})
        frames.append({"rgb": rgb, "depth": depth, "mask": None, "timestamp": i})
        gt.append(mask)
    return frames, gt


def _tree_to(tree, device):
    """A copy of an engine state (NamedTuples of tensors, host ints) on `device`."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_to(a, device) for a in tree))
    return tree


LOOP_CAM = dict(width=80, height=64, fx=66.0, fy=66.0, cx=40.0, cy=32.0)
SMALL_CAM = dict(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)


def _flags(state, closed) -> tuple:
    """(lost, loop closed, keyframes) of a state and its step's outputs."""
    db = state.fern_db
    return (bool(state.lost), bool(closed), int(db.count) if hasattr(db, "count") else 0)


NOISE_SEEDS = range(6)


def _ulp_noised(depth, seed: int):
    """`depth` scaled pixel by pixel by 1 + (-1, 0 or +1) x 2^-23 (about an
    ulp), drawn on the CPU from `seed`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.integers(-1, 2, tuple(depth.shape)).astype(np.float32))
    return depth * (1 + s.to(depth.device) * 2.0 ** -23)


class _Conditions:
    """Within it, every `odometry.track_models` call's systems are kept;
    `kappa()` is each slot's condition number of its worst Gauss-Newton
    system in the step.  A slot without a solved system keeps its pose:
    condition 1; the camera's bar takes the worst of its systems
    (tracking, the fern ICP, the local loop's model-to-model solve)."""

    def __enter__(self):
        from cofusion_tpu_torch.ops import odometry as od

        self.od, self.track, self.systems = od, od.track_models, []

        def tracked(*a, **kw):
            res = self.track(*a, **kw)
            self.systems.append(res.A)
            return res

        od.track_models = tracked
        return self

    def __exit__(self, *exc):
        self.od.track_models = self.track

    def kappa(self):
        import numpy as np

        conds = [np.nan_to_num(np.linalg.cond(A.double().cpu().numpy()), nan=1.0, posinf=1.0)
                 for A in self.systems]
        kappa = conds[0]
        kappa[0] = max(float(c.max()) for c in conds)
        return kappa


def _run_small(device, frames, kind: str):
    """A small run on `device`: at 160x128 "static" (max_models=1, 2^17
    surfels), "gt" (tests/test_multimodel.py's configuration), "crf"
    (tests/test_crf_engine.py's) or "reloc" (tests/test_reloc.py's); at
    80x64 "loop" (tests/test_local_loop.py's drift run: the map aged and
    the camera drifted before frame 6).  Returns per-frame (poses, active,
    counts, flags), the drained masks, and every step's input (state copy,
    frame tensors, run-time scalars, static options) and output state, plus
    the final state, so a step can be replayed on another device, and
    each step's conditions (`_Conditions.kappa`)."""
    import cofusion_tpu_torch.engine as engine_mod
    from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams

    cam = CameraConfig(**(LOOP_CAM if kind == "loop" else SMALL_CAM))
    options = {}
    if kind in ("static", "reloc"):
        cfg = CoFusionConfig(camera=cam, max_models=1, max_surfels=1 << (16 if kind == "reloc" else 17))
        fusion = dict(depth_cutoff=4.5)
        if kind == "reloc":
            fusion.update(fern_min_age=3, fern_icp_error_thresh=1.2e-3, confidence_global=1.0)
            options = dict(enable_relocalization=True)
    elif kind == "loop":
        cfg = CoFusionConfig(camera=cam, max_models=1, max_surfels=1 << 14, deform_nodes=64,
                             cons_sample=8)
        fusion, options = LOOP_FUSION, dict(close_loops=True)
    else:
        cfg = CoFusionConfig(camera=cam, max_models=3, max_surfels=1 << 16,
                             superpixel_size=6 if kind == "crf" else 16)
        fusion = MULTI_FUSION if kind == "crf" else dict(
            depth_cutoff=4.5, confidence_object=0.01, model_spawn_offset=0)
        options = dict(enable_multi_model=True)
    eng = engine_mod.CoFusion(cfg, fusion_params=FusionParams(**fusion), device=device, **options)
    steps, step = [], engine_mod._step

    def recording_step(state, *args, **kw):
        before = _tree_to(state, device)
        with _Conditions() as conds:
            new, outputs = step(state, *args, **kw)
        steps.append((before, args, kw, _tree_to(new, device), conds.kappa()))
        return new, outputs

    log = []
    engine_mod._step = recording_step
    try:
        for i, f in enumerate(frames):
            if kind == "loop" and i == 6:
                _age_and_drift(eng)
            eng.process_frame(f)
            st = eng.stats()
            closed = eng._last_outputs.loop_closed if eng._last_outputs is not None else False
            log.append((st["poses"], st["active"], st["surfel_counts"], _flags(eng.state, closed)))
    finally:
        engine_mod._step = step
    return log, dict(eng.drain_segmentation(flush=True)), steps, _tree_to(eng.state, device)


def _replay(steps, k, device, noise=None):
    """Step k (frame k + 1) replayed from its recorded input state on
    `device`, its depth frame `_ulp_noised` with seed `noise` if given:
    (poses, counts, active, mask, flags, condition number of each slot's
    worst Gauss-Newton system) of the replay, and (poses, counts, active,
    mask) of the recorded step's output state."""
    import torch

    from cofusion_tpu_torch.engine import _step

    state, args, kw, ref, _ = steps[k]
    state = _tree_to(state, device)
    args = tuple(_tree_to(a, device) if isinstance(a, torch.Tensor) else a for a in args)
    if noise is not None:  # _step(state, rgb, depth, mask, fparams)
        args = (args[0], _ulp_noised(args[1], noise)) + args[2:]
    with _Conditions() as conds:
        new, outputs = _step(state, *args, **kw)

    def out(st):
        m = st.models
        counts = m.store.count + torch.clamp(m.stable.count, max=m.stable.capacity)
        return (m.pose.cpu().numpy(), counts.cpu().numpy(), m.active.cpu().numpy(),
                st.prev_mask.cpu().numpy())

    return out(new) + (_flags(new, outputs.loop_closed), conds.kappa()), out(ref)


# The pose bars (1e-5 a step, + 2e-6 a frame over a run) are derived in
# __graft_entry__.py:162-176 for fp32 summation order through a 6x6 GN system
# of condition ~1e2; a slot whose system is worse conditioned (a small or
# freshly spawned object: 1e3-3e4) gets them scaled by its condition / 1e2,
# taken from the CPU's own step (ROADMAP C8)
STEP_BAR = 1e-5
KAPPA_REF = 1e2


def _parity(name, frames, kind):
    """CPU against card on one 160x128 run.  Every step of the CPU run is
    replayed on the card from the CPU's state (each slot's pose within
    STEP_BAR scaled by its system's condition, counts, active flags and the
    mask exact), and every step of the card's run on the CPU from the
    card's state, which gives the CPU's own response to the card's state.
    The whole runs must then agree within the bar plus that response:
    camera poses within the bar, each slot's pose within the scaled bar
    plus the response, and counts and masks on every frame where the CPU's
    replay keeps the CPU run's.  Where a step's counts part (the card's
    against the CPU's, from one state), both devices step again from that
    state with about an ulp of noise on the depth frame (`_ulp_noised`,
    NOISE_SEEDS) and the ranges of their counts must overlap (a frame whose
    fusion gates sit on fp32 rounding, ROADMAP C11); each such frame is
    listed.  Returns the phase line's fields and the card's run."""
    import numpy as np
    import torch

    cpu, cpu_masks, cpu_steps, cpu_final = _run_small("cpu", frames, kind)
    card, card_masks, card_steps, card_final = _run_small("cuda", frames, kind)
    n = len(frames)
    flip, worst_cam, worst_step, gap, scaled, kmax, parted_counts = n, 0.0, 0.0, None, [], None, []

    def within_noise(steps, k, card_counts, cpu_counts, where):
        """The card's and the CPU's counts of step k from `steps`' state,
        each with and without ulp noise on the depth, overlap in range."""
        on = {dev: np.stack([c] + [_replay(steps, k, dev, noise=seed)[0][1] for seed in NOISE_SEEDS])
              for dev, c in (("cpu", cpu_counts), ("cuda", card_counts))}
        lo = np.maximum(on["cpu"].min(0), on["cuda"].min(0))
        hi = np.minimum(on["cpu"].max(0), on["cuda"].max(0))
        parted_counts.append(dict(frame=k + 1, step=where, cpu=cpu_counts.tolist(), card=card_counts.tolist(),
                            cpu_noised=on["cpu"][1:].sum(1).tolist(),
                            card_noised=on["cuda"][1:].sum(1).tolist()))
        return bool((lo <= hi).all())

    for step in range(1, n):
        bar = 1e-5 + 2e-6 * step
        (pc, ac, cc, fc), (pg, ag, cg, fg) = cpu[step], card[step]
        # the CPU's own step (its systems' condition scales the bars), and one
        # card step from the CPU's state against it
        kappa = cpu_steps[step - 1][4]
        scale = np.maximum(1.0, kappa / KAPPA_REF)
        kmax = kappa if kmax is None else np.maximum(kmax, kappa)
        (rp, rc, ra, rm, rf, _), (qp, qc, qa, qm) = _replay(cpu_steps, step - 1, "cuda")
        d_step = np.abs(rp - qp).max(axis=(1, 2))
        worst_step = max(worst_step, float(d_step.max()))
        for m in np.flatnonzero(scale > 1.0):
            scaled.append(dict(frame=step, slot=int(m), condition=float(kappa[m]),
                               step_pose_diff=float(d_step[m]), step_bar=STEP_BAR * float(scale[m])))
        counts_ok = np.array_equal(rc, qc) or within_noise(cpu_steps, step - 1, rc, qc,
                                                           "card from the CPU's state")
        if not ((d_step <= STEP_BAR * scale).all() and counts_ok and np.array_equal(ra, qa)
                and np.array_equal(rm, qm) and rf == fc):
            raise RuntimeError(f"{name} parity: the card's step from the CPU state at frame {step}: "
                               f"pose |d| {d_step} (bars {STEP_BAR * scale}), counts {rc} vs {qc} "
                               f"(under ulp noise: {parted_counts[-1:]}), active {ra} vs {qa}, mask equal "
                               f"{np.array_equal(rm, qm)}, (lost, closed, keyframes) {rf} vs {fc}")
        # the CPU's own response to the card's state
        (op, oc, _, om, _, _), _ = _replay(card_steps, step - 1, "cpu")
        response = np.abs(op - pc).max(axis=(1, 2))
        keeps = np.array_equal(oc, cc) and np.array_equal(om, cpu_masks[step + 1])
        d_cam = float(np.abs(pc[0] - pg[0]).max())
        worst_cam = max(worst_cam, d_cam)
        d = np.abs(pc - pg).max(axis=(1, 2))
        same = np.array_equal(cc, cg) and np.array_equal(cpu_masks[step + 1], card_masks[step + 1])
        # the camera is held to the bar alone, except where the step solves
        # the loop's or the fern's systems too (C8's scaled bar and response)
        cam_bar = bar * scale[0] + response[0] if kind in ("loop", "reloc") else bar
        # the runs' counts part at a step of their own: the card's step from
        # its state against the CPU's from the same state
        parted = keeps and not same and not (
            np.array_equal(cpu_masks[step + 1], card_masks[step + 1])
            and within_noise(card_steps, step - 1, cg, oc, "CPU from the card's state"))
        if d_cam > cam_bar or not np.array_equal(ac, ag) or fc != fg or (
                d > bar * scale + response).any() or parted:
            raise RuntimeError(f"{name} parity: frame {step} camera {d_cam}, poses {d} (bars "
                               f"{bar * scale} + the CPU's response {response}), active {ac} vs {ag}, "
                               f"counts {cc} vs {cg}, masks equal {same}, CPU replay keeps its "
                               f"counts/mask {keeps} (under ulp noise: {parted_counts[-1:]}), (lost, closed, "
                               f"keyframes) {fc} vs {fg}")
        if flip == n and ((d > bar).any() or not same):
            flip, gap = step, dict(pose_diff=d.tolist(), cpu_counts=cc.tolist(), card_counts=cg.tolist(),
                                   masks_equal=same, cpu_response=response.tolist(),
                                   cpu_replay_counts=oc.tolist())
    line = dict(path=name, frames=n, camera=f"{cpu_final.prev_rgb.shape[1]}x{cpu_final.prev_rgb.shape[0]}",
                max_camera_pose_diff=worst_cam,
                max_step_pose_diff=worst_step,
                bar="1e-5+2e-6*step; one step 1e-5; a slot's x max(1, condition/1e2)",
                max_condition_per_slot=[round(float(k), 1) for k in kmax], scaled_bars=scaled,
                first_frame_off_bar=flip, there=gap, counts_part_within_ulp_noise=parted_counts,
                cpu_counts=cpu[-1][2].tolist(), card_counts=card[-1][2].tolist())
    db_cpu, db_card = cpu_final.fern_db, card_final.fern_db
    if hasattr(db_cpu, "codes"):
        if not torch.equal(db_cpu.codes.cpu(), db_card.codes.cpu()):
            raise RuntimeError(f"{name} parity: keyframe codes differ between CPU and card")
        line["keyframes"] = int(db_card.count)
        line["keyframe_codes"] = "equal"
    return line, card, card_masks


def phase_parity():
    from cofusion_tpu_torch.config import CameraConfig
    from cofusion_tpu_torch.io.synthetic import make_sequence

    cam = CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
    frames, _, _ = make_sequence(cam, 12)
    line, _, _ = _parity("static", frames, "static")
    _phase("parity", **line)


def phase_parity_multi():
    import numpy as np

    from cofusion_tpu_torch.config import CameraConfig
    from cofusion_tpu_torch.io.synthetic import make_sequence

    cam = CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
    gt_frames, _, _ = make_sequence(cam, 8, kind="orbit", moving_object=True)
    crf_frames, crf_gt = _teleport_frames(cam)
    for name, frames, kind in (("gt_masks", gt_frames, "gt"), ("crf_teleport", crf_frames, "crf")):
        line, card, card_masks = _parity(name, frames, kind)
        n = len(frames)
        line["spawn_frame"] = next(i for i, (_, a, *_) in enumerate(card) if a[1:].any())
        if kind == "crf":
            slot = 1 + int(np.argmax(card[-1][1][1:]))
            line["card_settled_iou"] = [round(_iou(card_masks[i + 1] == slot, crf_gt[i] == 1), 4)
                                        for i in (n - 2, n - 1)]
        _phase("multi_parity", **line)
        if kind == "crf" and not min(line["card_settled_iou"]) > 0.6:
            raise RuntimeError(f"teleport IoU on the card {line['card_settled_iou']} <= 0.6")


# --- relocalisation and loop closure ('-rl -cl', ROADMAP A12-A13)
LOOP_FRAMES = 20
LOOP_FUSION = dict(depth_cutoff=4.5, confidence_global=1.0, local_loop_cov_thresh=1e-4,
                   local_loop_err_thresh=5e-4)
DRIFT = (0.03, 0.015, 0.0)


def _loop_engine(dev, reloc=True, close=True, time_delta=200, **fusion):
    """`-static -rl -cl` at full width: CoFusionConfig(max_models=1) (2^20
    surfels, active 2^19, deform_nodes 256, cons_sample 20)."""
    from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams
    from cofusion_tpu_torch.engine import CoFusion

    cfg = CoFusionConfig(camera=CameraConfig(), max_models=1, time_delta=time_delta)
    return CoFusion(cfg, fusion_params=FusionParams(**dict(dict(depth_cutoff=4.5), **fusion)),
                    enable_relocalization=reloc, close_loops=close, device=dev)


def phase_loop_path(dev, frames, gt):
    """LOOP_FRAMES orbit frames through `-static -rl -cl`, frames 3.. under
    the sync check; launch counters, ATE, keyframes, peak memory."""
    import numpy as np
    import torch

    from cofusion_tpu_torch.utils.export import ate_rmse

    frames, gt = frames[:LOOP_FRAMES], gt[:LOOP_FRAMES]
    eng = _loop_engine(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold: the path's own peak is above it
    before = torch.cuda.memory_allocated()
    _zero_counts()
    t0 = time.perf_counter()
    eng.process_frame(frames[0])
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    eng.process_frame(frames[1])
    torch.cuda.synchronize()
    closed, t0 = [], time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in frames[2:]:
            eng.process_frame(f)
            closed.append(eng._last_outputs.loop_closed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    checked_ms = (time.perf_counter() - t0) * 1e3 / len(frames[2:])
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    est = [p[1][0] for p in eng.pose_log]
    ate = ate_rmse(est, gt, align=False)
    n = len(frames)
    keyframes = int(eng.state.fern_db.count)
    lost = bool(eng.state.lost)
    n_closed = int(sum(bool(c) for c in closed))
    _phase("loop_path", frames=n, launches=launches,
           splat_per_frame=f"{(launches['splat_window'] - 1) / (n - 1):.2f}",
           ate_m=f"{ate:.6f}", surfels=eng.surfel_count(0), keyframes=keyframes, lost=lost,
           loops_closed=n_closed, first_frame_ms=f"{first_ms:.3f}", max_memory_allocated_bytes=peak,
           allocated_before_bytes=before, path_peak_bytes=peak - before,
           sync_debug=f"error on frames 3-{n}", checked_ms_per_frame=f"{checked_ms:.3f}")
    # the init render, then 4 splats a frame: the prediction, the loop's
    # active view and its two inactive tiers
    if launches["bilateral_filter"] != n or launches["splat_window"] != 1 + 4 * (n - 1):
        raise RuntimeError(f"loop path launches {launches}, expected {n} and {1 + 4 * (n - 1)}")
    if not ate < 0.003:
        raise RuntimeError(f"loop path ATE {ate:.6f} m >= 3 mm")
    if lost or keyframes < 1 or not all(np.isfinite(p).all() for p in est):
        raise RuntimeError(f"loop path: lost {lost}, keyframes {keyframes}, finite poses")
    return launches, eng


def phase_loop_blocks(eng):
    """Device busy ms of the blocks '-rl' and '-cl' add to every frame (the
    deformation branch is computed whether a loop closes or not), each from
    torch.profiler over 2 calls on copies of the final state: the sum of
    the device time of the kernels they launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import cofusion_tpu_torch.engine as em
    from cofusion_tpu_torch.ops import deformation as df

    st, cfg, cam = eng.state, eng.cfg, eng.cam
    fp = dict(eng._fparams, weight_multiplier=1.0)
    A0 = torch.eye(6, device=st.prev_rgb.device) * 1e6
    pose0, conf0 = st.models.pose[0], st.models.conf_threshold[0]
    store0, stable0 = em._unbatch(st.models.store), em._unbatch(st.models.stable)
    tick = st.tick + 1

    def reloc():
        s = _tree_to(st, st.prev_rgb.device)
        return em._relocalise(s, A0, pose0, st.prev_rgb, st.prev_filtered, cam, cfg, eng.tracking,
                              fp, tick)

    fern = reloc()[4]

    def close():
        s = _tree_to(st, st.prev_rgb.device)
        return em._close_loop(s, _tree_to(store0, pose0.device), _tree_to(stable0, pose0.device),
                              pose0, conf0, st.lost, fern, cam, cfg, eng.tracking, fp, tick)

    graph = df.sample_graph(em.sm.concat_stores(stable0, store0), cfg.deform_nodes)
    C = (cam.height + cfg.cons_sample - 1) // cfg.cons_sample * ((cam.width + cfg.cons_sample - 1)
                                                              // cfg.cons_sample)
    src = graph.positions.index_select(0, torch.arange(C, device=pose0.device) % cfg.deform_nodes)
    times = graph.times.index_select(0, torch.arange(C, device=pose0.device) % cfg.deform_nodes)
    ok = torch.ones(C, dtype=torch.bool, device=pose0.device)

    def solve():
        return df.optimize(graph, src, times, src + 0.01, ok)

    out = {}
    for name, fn in (("reloc_block", reloc), ("close_loop_block", close), ("graph_solve", solve)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / 2
        launches = sum(e.count for e in events if "LaunchKernel" in e.key) / 2
        out[name] = dict(device_busy_ms=f"{busy:.3f}" if busy else "not measured",
                         launches=launches,
                         peak_extra_bytes=torch.cuda.max_memory_allocated() - base)
    _phase("loop_blocks", constraints=C, deform_nodes=cfg.deform_nodes,
           jacobian_bytes=(18 * cfg.deform_nodes + 3 * C) * 12 * cfg.deform_nodes * 4, **out,
           method="torch.profiler over 2 calls on copies of the final state")


def _age_and_drift(eng, stamp=-500.0):
    """Age the whole active tier out of the time window (its surfels
    stamped `stamp`, in place, shard by shard where sharded) and add DRIFT
    to the camera (tests/test_local_loop.py's drift scenario)."""
    import torch

    from cofusion_tpu_torch.models import surfel_model as sm

    st = eng.state
    for s in sm.shards_of(st.models.store)[0]:
        s.last_time[0].copy_(torch.where(s.valid[0], stamp, s.last_time[0]))
    pose = st.models.pose.clone()
    pose[0, :3, 3] += torch.tensor(DRIFT, dtype=pose.dtype).to(pose.device, non_blocking=True)
    eng.state = st._replace(models=st.models._replace(pose=pose))


def _splat_on_views(eng, tiers):
    """The splat kernel against its plain version, bit for bit, on index
    maps of the current state (sharded or not): `tiers` is a list of
    (name, store, time delta, active window), each rendered at slot 0's
    pose and splatted as splat_from_imap splats it."""
    import torch

    import cofusion_tpu_torch.engine as em
    from cofusion_tpu_torch.ops import cuda_splat
    from cofusion_tpu_torch.ops import rasterize as rz

    st, cfg, cam, fp = eng.state, eng.cfg, eng.cam, eng._fparams
    pose0, conf0 = st.models.pose[0], st.models.conf_threshold[0]
    rows = []
    for tier, store, td, active in tiers:
        imap = rz.predict_indices(em._slot0(store), pose0, cam, st.tick, td,
                                  fp["depth_cutoff"], conf_threshold=conf0, active_window=active)
        args = (imap.vert_conf[None, ..., :3], imap.normal_rad[None, ..., :3],
                imap.normal_rad[None, ..., 3], imap.valid[None], cfg.splat_radius,
                (cam.fx, cam.fy, cam.cx, cam.cy))
        n = cuda_splat.splat_window_cuda.launches
        z_k, tap_k = cuda_splat.splat_window_cuda(*args)
        cuda_splat.splat_window_cuda.launches = n  # a check, not the path's launch
        z_p, tap_p = cuda_splat.splat_window_plain(*args)
        torch.cuda.synchronize()
        mism = int((tap_k != tap_p).sum())
        rows.append(dict(map=tier, valid_pixels=int(imap.valid.sum()), tap_mismatches=mism,
                         max_abs_z_err=_max_err(z_k, z_p)))
        if mism or not torch.equal(z_k, z_p):
            raise RuntimeError(f"splat kernel differs from plain on the {tier} map: {rows[-1]}")
    return rows


def _splat_on_loop_maps(eng):
    """The splat kernel against its plain version on the loop block's own
    index maps of the current state: the active view and the inactive
    views of both tiers."""
    m, td = eng.state.models, eng._fparams["time_delta"]
    return _splat_on_views(eng, [("active view", m.store, td, True),
                                 ("inactive, active tier", m.store, td, False),
                                 ("inactive, stable tier", m.stable, td, False)])


def phase_loop_closure(dev, frames, gt):
    """tests/test_local_loop.py's drift scenario at 640x480: 6 frames warm
    the map, the map is aged out of the window and the camera drifts by
    DRIFT, 4 more frames.  A closure must fire and the final camera error
    must be below half that of the same run without '-cl'.  The splat
    kernel is held to its plain version on this run's own index maps,
    right after the drift (the aged map: the inactive view) and at the end
    (the closure refreshed the map's stamps: the active view).  The stable
    tier stays empty here (nothing is 200 frames old)."""
    import numpy as np

    n_warm = 6
    errs, closed_at, kernel_rows = {}, None, None
    for close in (True, False):
        eng = _loop_engine(dev, reloc=False, close=close, **LOOP_FUSION)
        for f in frames[:n_warm]:
            eng.process_frame(f)
        _age_and_drift(eng)
        if close:
            kernel_rows = [dict(row, frame=n_warm) for row in _splat_on_loop_maps(eng)]
        closed = []
        for f in frames[n_warm:]:
            eng.process_frame(f)
            closed.append(bool(eng._last_outputs.loop_closed))
        if close:
            kernel_rows += [dict(row, frame=len(frames)) for row in _splat_on_loop_maps(eng)]
        errs[close] = float(np.linalg.norm(eng.camera_pose()[:3, 3] - gt[-1][:3, 3]))
        if close:
            closed_at = [n_warm + i for i, c in enumerate(closed) if c]
    _phase("loop_closure", frames=len(frames), drift_m=DRIFT, closed_at_frames=closed_at,
           camera_err_closed_m=f"{errs[True]:.6f}", camera_err_open_m=f"{errs[False]:.6f}",
           ratio=f"{errs[True] / errs[False]:.3f}", bar="a closure fires; ratio < 0.5")
    for row in kernel_rows:
        _phase("kernels", kernel="splat_window", on="loop closure's own index maps", **row,
               bar="bit-equal")
    if not closed_at or not errs[True] < 0.5 * errs[False]:
        raise RuntimeError(f"drift scenario: closures at {closed_at}, errors {errs}")


def _blackout_frames(cam):
    """tests/test_reloc.py's blackout: 6 frames of the scene, 14 of a
    blacked-out sensor, 3 of the scene seen from 7 cm away (T_re)."""
    import numpy as np

    from cofusion_tpu_torch.io.synthetic import SyntheticScene

    scene = SyntheticScene()
    rgb0, d0, _ = scene.render(cam, np.eye(4))
    rgb_re, d_re, _ = scene.render(cam, _t_re())
    seq = [(rgb0, d0)] * 6 + [(np.full_like(rgb0, 10), np.zeros_like(d0))] * 14 + [(rgb_re, d_re)] * 3
    return [{"rgb": r, "depth": d, "mask": None, "timestamp": i} for i, (r, d) in enumerate(seq)]


def _t_re():
    import numpy as np

    T_re = np.eye(4)
    T_re[:3, 3] = (0.06, -0.03, 0.02)
    return T_re


def phase_reloc(dev):
    """tests/test_reloc.py's blackout scenario at 640x480: 6 frames of the
    scene, 14 of a blacked-out sensor, 3 of the scene seen from 7 cm away
    (fern_min_age 3, confidence_global 1).  Lost during the blackout, at
    least one keyframe, and the pose recovered within 3 cm."""
    import numpy as np

    from cofusion_tpu_torch.config import CameraConfig

    eng = _loop_engine(dev, close=False, fern_min_age=3, confidence_global=1.0)
    T_re = _t_re()
    seq = _blackout_frames(CameraConfig())
    lost = []
    for f in seq:
        eng.process_frame(f)
        lost.append(bool(eng.state.lost))
    err = float(np.linalg.norm(eng.camera_pose()[:3, 3] - T_re[:3, 3]))
    keyframes = int(eng.state.fern_db.count)
    _phase("reloc", frames=len(seq), lost_frames=[i for i, x in enumerate(lost) if x],
           keyframes=keyframes, recovered_at=next((i for i in range(20, len(seq)) if not lost[i]), None),
           final_error_m=f"{err:.6f}", bar="lost in the blackout, >= 1 keyframe, error < 0.03")
    if any(lost[:6]) or not any(lost[6:20]) or lost[-1] or keyframes < 1 or not err < 0.03:
        raise RuntimeError(f"blackout scenario: lost {lost}, keyframes {keyframes}, error {err}")


def phase_loop_parity():
    """CPU against card by replayed steps (as phases 6 and 9): the drift run
    at 80x64 and the blackout run at 160x128; lost, loop-closed and the
    keyframe count on every frame and the final keyframe codes exact."""
    from cofusion_tpu_torch.config import CameraConfig
    from cofusion_tpu_torch.io.synthetic import make_sequence

    drift_frames, _, _ = make_sequence(CameraConfig(**LOOP_CAM), 10, kind="still")
    reloc_frames = _blackout_frames(CameraConfig(**SMALL_CAM))
    for name, frames, kind in (("loop_drift", drift_frames, "loop"), ("reloc_blackout", reloc_frames, "reloc")):
        line, card, _ = _parity(name, frames, kind)
        line["closed_at"] = [i for i, rec in enumerate(card) if rec[3][1]]
        line["lost_frames"] = [i for i, rec in enumerate(card) if rec[3][0]]
        _phase("loop_parity", **line)
        if kind == "loop" and not line["closed_at"]:
            raise RuntimeError("loop parity: the drift run closed no loop")
        if kind == "reloc" and (not line["lost_frames"] or card[-1][3][0]):
            raise RuntimeError(f"reloc parity: lost frames {line['lost_frames']}")


# --- the remaining surfaces: '-p', render_views, checkpoints, hot tuning
def _gt_poses(gt):
    """float64 (4, 4) poses relative to the first, as GroundTruthOdometry
    accumulates them."""
    import numpy as np

    first = np.linalg.inv(np.asarray(gt[0], np.float64))
    return [first @ np.asarray(g, np.float64) for g in gt]


def phase_gt_pose(dev, frames, gt):
    """'-p' on the static configuration (phase 4's): 30 orbit frames fed
    their ground-truth poses, frames 3-30 under the sync check.  The logged
    poses must be the given ones (as fp32) on every frame; the bilateral
    kernel runs once a frame, the splat only in the first frame's render
    (the '-p' step carries the prediction).  Then a rerun with no sync
    check (steady ms/frame, bit-identical) and a 1-frame profile, and the
    same on the multi path's GT-mask frames with 4 slots (12 frames:
    '-p' skips segmentation, so no object spawns).  Returns the launch
    counts of the static run."""
    import numpy as np
    import torch

    from cofusion_tpu_torch.config import CameraConfig
    from cofusion_tpu_torch.io.synthetic import camera_trajectory, make_multi_object_frames

    poses = _gt_poses(gt)
    eng = _engine(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    for i, f in enumerate(frames[:2]):
        eng.process_frame(f, gt_pose=poses[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2, len(frames)):
            eng.process_frame(frames[i], gt_pose=poses[i])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    checked_ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - 2)
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    logged = [p[1][0] for p in eng.pose_log]
    off = [i for i in range(1, len(frames)) if not np.array_equal(logged[i], poses[i].astype(np.float32))]
    n = eng.surfel_count(0)
    _phase("gt_pose", frames=len(frames), launches=launches, surfels=n,
           poses="equal to the given fp32 poses" if not off else f"differ at {off}",
           max_memory_allocated_bytes=peak, sync_debug=f"error on frames 3-{len(frames)}",
           checked_ms_per_frame=f"{checked_ms:.3f}")
    if off:
        raise RuntimeError(f"'-p' logged poses differ from the given ones at frames {off}")
    if launches["bilateral_filter"] != len(frames) or launches["splat_window"] != 1:
        raise RuntimeError(f"'-p' path launches {launches}: expected {len(frames)} bilateral, 1 splat")
    if not 0.3 * eng.cam.width * eng.cam.height < n:
        raise RuntimeError(f"'-p' map holds {n} surfels")
    phase_timing(lambda: _engine(dev), frames, eng, tag="gt_pose_timing", gt=poses)
    del eng

    # the multi path's GT-mask scene, 4 slots: every active slot fuses at
    # its pose (here the global one alone: '-p' spawns nothing)
    cam = CameraConfig()
    unique = make_multi_object_frames(cam, 12, masks=True)
    m = 12 // 2 + 1
    cam_poses = camera_trajectory(m, kind="orbit")
    order = list(range(m)) + list(range(m - 2, 0, -1))
    mposes = _gt_poses([cam_poses[j] for j in order[:12]])
    meng = _multi_engine(dev, model_spawn_offset=2)
    torch.cuda.synchronize()
    _zero_counts()
    for i, f in enumerate(unique[:2]):
        meng.process_frame(f, gt_pose=mposes[i])
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2, len(unique)):
            meng.process_frame(unique[i], gt_pose=mposes[i])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    mlaunches = _read_counts()
    mlogged = [p[1][0] for p in meng.pose_log]
    moff = [i for i in range(1, 12) if not np.array_equal(mlogged[i], mposes[i].astype(np.float32))]
    _phase("gt_pose_multi", frames=len(unique), slots=meng.cfg.max_models, launches=mlaunches,
           surfels=meng.stats()["surfel_counts"].tolist(),
           active=meng.state.models.active.tolist(),
           poses="equal to the given fp32 poses" if not moff else f"differ at {moff}",
           sync_debug=f"error on frames 3-{len(unique)}")
    if moff or mlaunches["bilateral_filter"] != len(unique):
        raise RuntimeError(f"'-p' multi path: poses off at {moff}, launches {mlaunches}")
    phase_timing(lambda: _multi_engine(dev, model_spawn_offset=2), unique, meng,
                 tag="gt_pose_multi_timing", gt=mposes)
    return launches


def phase_render_views(dev, frames, static_eng):
    """`render_views` (the '-en'/'-ev' exports) on the final state of phase
    4's run and of the same 30 orbit frames with time delta 5 ('-t 5': what
    the orbit leaves behind ages out of the window within 5 frames, so the
    stable tier fills) and global confidence 1.5.
    On both: the splat kernel bit-equal to its plain version on each tier's
    own index map (the active tier within the window, the stable tier with
    none), the valid pixels of each, the launches of one call and its
    device ms (torch.profiler over 2 calls).  Returns the launch counts of
    one call and the '-t 5' engine."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams
    from cofusion_tpu_torch.engine import CoFusion

    if static_eng is None:  # run alone ('--only surfaces'): phase 4's run again
        static_eng = _engine(dev)
        for f in frames:
            static_eng.process_frame(f)
    # '-t 5 -confG 1.5': the surfels that age out are the ones the orbit
    # left behind, seen a few times only; the render's confidence gate at
    # the default 10 would show none of them
    t5 = CoFusion(CoFusionConfig(camera=CameraConfig(), max_models=1, time_delta=5),
                  fusion_params=FusionParams(depth_cutoff=4.5, confidence_global=1.5), device=dev)
    for f in frames:
        t5.process_frame(f)
    launches, stable_pixels = None, 0
    for name, eng in (("static", static_eng), ("time_delta_5", t5)):
        m = eng.state.models
        rows = _splat_on_views(eng, [
            ("active tier", m.store, eng.cfg.time_delta, True),
            ("stable tier", m.stable, 1 << 30, True),
        ])
        stable_pixels = max(stable_pixels, rows[1]["valid_pixels"])
        torch.cuda.synchronize()
        _zero_counts()
        views = eng.render_views()
        launches = _read_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                eng.render_views()
            torch.cuda.synchronize()
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / 2
        t0 = time.perf_counter()
        eng.render_views()
        wall_ms = (time.perf_counter() - t0) * 1e3
        finite = bool(np.isfinite(views["image"][views["valid"]]).all()
                      and np.isfinite(views["normal"][views["valid"]]).all())
        _phase("render_views", state=name, stable_count=int(m.stable.count[0]),
               active_count=int(m.store.count[0]), valid_pixels=int(views["valid"].sum()),
               launches_per_call=launches,
               device_ms_per_call=f"{busy_ms:.3f}" if busy_ms else "not measured",
               wall_ms_per_call=f"{wall_ms:.3f}", finite=finite)
        for row in rows:
            _phase("kernels", kernel="splat_window", on=f"render_views, {name}", **row, bar="bit-equal")
        if launches["splat_window"] != 2 or not finite or not views["valid"].any():
            raise RuntimeError(f"render_views on {name}: launches {launches}, finite {finite}")
    if not stable_pixels:
        raise RuntimeError("the stable tier's view is empty in both states")
    return launches, t5


def phase_checkpoint(dev, frames):
    """Save the static orbit's engine at frame 15, resume in a new engine
    and run to frame 30: poses, counts and both map tiers bit-identical to
    the run that went on uninterrupted.  The same file loads into an engine
    on the CPU with an equal state.  Save and load seconds, file size."""
    import tempfile

    import numpy as np
    import torch

    from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams
    from cofusion_tpu_torch.engine import CoFusion
    from cofusion_tpu_torch.utils import checkpoint as ckpt

    k = 15
    a = _engine(dev)
    for f in frames[:k]:
        a.process_frame(f)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "cofusion_tpu_torch", "_build")) as tmp:
        path = os.path.join(tmp, "engine.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_engine(a, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        b = _engine(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.load_engine(b, path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        cpu = CoFusion(CoFusionConfig(camera=CameraConfig(), max_models=1),
                       fusion_params=FusionParams(depth_cutoff=4.5), device="cpu")
        ckpt.load_engine(cpu, path)
    on_card = ckpt.flatten_state(b.state)
    on_cpu = ckpt.flatten_state(cpu.state)
    cpu_equal = on_card.keys() == on_cpu.keys() and all(
        (on_card[key] == on_cpu[key]) if not isinstance(on_card[key], torch.Tensor)
        else (on_cpu[key].device.type == "cpu" and torch.equal(on_card[key].cpu(), on_cpu[key]))
        for key in on_card
    )
    del cpu, on_card, on_cpu
    for f in frames[k:]:
        a.process_frame(f)
        b.process_frame(f)
    pa = [p[1] for p in a.pose_log]
    pb = [p[1] for p in b.pose_log]
    poses_equal = len(pa) == len(pb) == len(frames) and all(np.array_equal(x, y) for x, y in zip(pa, pb))
    maps_equal = all(
        torch.equal(x, y)
        for tier in ("store", "stable")
        for x, y in zip(getattr(a.state.models, tier), getattr(b.state.models, tier))
    )
    _phase("checkpoint", saved_at_frame=k, frames=len(frames), file_bytes=size,
           save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}", surfels=b.surfel_count(0),
           resumed="bit-identical" if poses_equal and maps_equal else "differs",
           cpu_load="equal" if cpu_equal else "differs")
    if not (poses_equal and maps_equal and cpu_equal):
        raise RuntimeError(f"checkpoint: poses {poses_equal}, maps {maps_equal}, cpu load {cpu_equal}")


HOT_FRAME = 4  # the frame before which set_params runs
HOT_PARAMS = dict(depth_cutoff=3.0, icp_weight=25.0, outlier_coefficient=5.0)


def phase_hot_params(dev):
    """set_params(depth_cutoff, icp_weight, outlier_coefficient) and
    set_confidence_threshold(0, ...) between frames of the static path
    (160x128, 8 orbit frames), on the card under the sync check: the run
    parts from an untouched one from that frame on, and its poses stay
    within 1e-5 + 2e-6*step of the CPU run given the same calls, counts
    equal."""
    import numpy as np
    import torch

    from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams
    from cofusion_tpu_torch.engine import CoFusion
    from cofusion_tpu_torch.io.synthetic import make_sequence

    cam = CameraConfig(**SMALL_CAM)
    frames, _, _ = make_sequence(cam, 8, kind="orbit")

    def run(device, tune):
        eng = CoFusion(CoFusionConfig(camera=cam, max_models=1, max_surfels=1 << 17),
                       fusion_params=FusionParams(depth_cutoff=4.5, confidence_global=1.5),
                       device=device)
        poses, counts = [], []
        try:
            for i, f in enumerate(frames):
                if torch.device(device).type == "cuda" and i == 2:
                    torch.cuda.set_sync_debug_mode("error")
                if tune and i == HOT_FRAME:
                    eng.set_params(**HOT_PARAMS)
                    eng.set_confidence_threshold(0, 2.5)
                eng.process_frame(f)
                poses.append(eng.state.models.pose[0].clone())
                counts.append(eng.state.models.store.count[0].clone())
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return [p.cpu().numpy() for p in poses], [int(c) for c in counts]

    base_p, base_c = run(dev, False)
    card_p, card_c = run(dev, True)
    cpu_p, cpu_c = run("cpu", True)
    parted = [i for i in range(len(frames))
              if card_c[i] != base_c[i] or not np.array_equal(card_p[i], base_p[i])]
    gaps = [float(np.abs(a - b).max()) for a, b in zip(card_p, cpu_p)]
    over = [i for i, g in enumerate(gaps) if g > 1e-5 + 2e-6 * i]
    _phase("hot_params", frames=len(frames), set_before_frame=HOT_FRAME, params=HOT_PARAMS,
           conf_threshold_0=2.5, parted_from_untouched_at=parted,
           max_pose_gap_to_cpu=f"{max(gaps):.3e}", counts_card=card_c, counts_cpu=cpu_c,
           sync_debug="error on frames 3-8", bar="1e-5 + 2e-6*step; counts equal")
    if parted != list(range(HOT_FRAME, len(frames))) or over or card_c != cpu_c:
        raise RuntimeError(f"hot params: parted at {parted}, over the bar at {over}, "
                           f"counts {card_c} vs {cpu_c}")


# --- the dataset-to-score path: the CLI over files on disk, scored by the
# port's own tools, with OpenCV and matplotlib unimportable
CLI_FRAMES = 40
CLI_STATIC_FRAMES = 30
CLI_FLAGS = ["-run", "-q", "-d", "4.5", "-confG", "1.5", "-confO", "0.01", "-offset", "4"]


def _bench_camera_track(n: int):
    """The camera poses of make_multi_object_frames(cam, 12) replayed for
    `n` frames: its 7 unique orbit poses played 0..6, 5..1 in a loop."""
    from cofusion_tpu_torch.io.synthetic import camera_trajectory

    uniq = camera_trajectory(7, kind="orbit")
    order = list(range(7)) + list(range(5, 0, -1))
    return [uniq[order[i % 12]] for i in range(n)]


def _write_image_dataset(root, cam, frames, gt_ids):
    """`frames` as an image directory in the layout of
    tests/test_e2e_cli.py's `_write_dataset`, written by the port's own PNG
    encoder: root/ds/Color####.png, Depth####.png (16-bit millimetres),
    calibration.txt; the ground-truth object ids in root/gt_masks/Mask####.png
    (a sibling directory, so the CLI runs the CRF path)."""
    import numpy as np

    from cofusion_tpu_torch.io.png import write_png

    ds, masks = os.path.join(root, "ds"), os.path.join(root, "gt_masks")
    os.makedirs(ds)
    os.makedirs(masks)
    for i, f in enumerate(frames):
        write_png(os.path.join(ds, f"Color{i:04d}.png"), f["rgb"])
        mm = np.clip(np.asarray(f["depth"]) * 1000.0, 0, 65535).astype(np.uint16)
        write_png(os.path.join(ds, f"Depth{i:04d}.png"), mm)
        write_png(os.path.join(masks, f"Mask{i:04d}.png"), gt_ids[i].astype(np.uint8))
    with open(os.path.join(ds, "calibration.txt"), "w") as fh:
        fh.write(f"{cam.fx} {cam.fy} {cam.cx} {cam.cy} {cam.width} {cam.height}\n")
    return ds, masks


def _score(export_dir, gt_npy, gt_masks=None, min_px=768) -> dict:
    """`python -m cofusion_tpu_torch.tools.evaluate` on an export directory:
    its JSON line."""
    import contextlib
    import io

    from cofusion_tpu_torch.tools import evaluate

    argv = ["--export", export_dir, "--gt-poses", gt_npy, "--no-align"]
    if gt_masks:
        argv += ["--gt-masks", gt_masks, "--min-px", str(min_px)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = evaluate.main(argv)
    if rc != 0:
        raise RuntimeError(f"evaluate {argv} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _cli_run(argv, n_frames, device):
    """`cofusion_tpu_torch.cli.run(argv)` (what `python -m cofusion_tpu_torch`
    calls) with the kernel counts set to 0 just before it: (wall ms per
    frame, launches, lifecycle events, the engine)."""
    import torch

    from cofusion_tpu_torch import cli

    built = {}
    build = cli.build_from_args

    def listening(args):
        reader, eng, opt = build(args)
        built["engine"], built["events"] = eng, _listen(eng)
        return reader, eng, opt

    cli.build_from_args = listening
    try:
        if device != "cpu":
            torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        rc = cli.run(argv + ["-device", device])
        if device != "cpu":
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_frames
        launches = _read_counts()
    finally:
        cli.build_from_args = build
    if rc != 0:
        raise RuntimeError(f"cli.run({argv}) exited {rc}")
    return wall_ms, launches, built["events"], built["engine"]


def phase_cli(cam, unique, static_frames, static_gt, device="cuda", n=CLI_FRAMES, n_static=CLI_STATIC_FRAMES):
    """A recorded dataset taken to a score with the port alone, through the
    entry points a user calls, with `cv2` and `matplotlib` unimportable:
    the bench scene (`unique`, make_multi_object_frames(cam, 12) with its
    object ids) replayed to `n` frames and written as PNG files, run by the
    CLI in the default multi-model CRF mode with '-ep -es -em', scored by
    `tools.evaluate` against the scene's camera track and object masks and
    viewed by `tools.view --no-png`; then `-static -l` over a raw-RGB .klg
    of `static_frames[:n_static]`, scored alike.  Both kernels must launch
    on each run: the bilateral once a frame, the splat at least once a
    frame after the first.  Returns the multi run's launches."""
    import shutil

    import numpy as np

    from cofusion_tpu_torch.io import png
    from cofusion_tpu_torch.io.readers import write_klg
    from cofusion_tpu_torch.tools import view

    root = os.path.join(REPO, "cofusion_tpu_torch", "_build", "cli_smoke")
    shutil.rmtree(root, ignore_errors=True)
    frames = [unique[i % len(unique)] for i in range(n)]
    gt_ids = [f["mask"] for f in frames]
    t0 = time.perf_counter()
    ds, gt_masks = _write_image_dataset(root, cam, frames, gt_ids)
    gt_npy = os.path.join(root, "gt.npy")
    np.save(gt_npy, np.stack(_bench_camera_track(n)))
    write_s = time.perf_counter() - t0
    hidden = {m: sys.modules.get(m) for m in ("cv2", "matplotlib")}
    sys.modules.update(cv2=None, matplotlib=None)
    try:
        # the decoder alone, on this dataset: colour and depth of every frame
        t0 = time.perf_counter()
        for i in range(n):
            png.imread(os.path.join(ds, f"Color{i:04d}.png"), "color")
        color_ms = (time.perf_counter() - t0) * 1e3 / n
        t0 = time.perf_counter()
        for i in range(n):
            png.imread(os.path.join(ds, f"Depth{i:04d}.png"), "anydepth")
        depth_ms = (time.perf_counter() - t0) * 1e3 / n

        out = os.path.join(root, "out")
        wall_ms, launches, events, eng = _cli_run(
            ["-dir", ds, "-pngScale", "0.001", *CLI_FLAGS, "-ep", "-es", "-em", "-exportdir", out],
            n, device)
        age = eng.state.models.age.cpu().numpy()
        active = eng.stats()["active"]
        spawned_at = {m: n - int(age[m]) for m in range(1, len(active)) if active[m]}
        del eng
        score = _score(out, gt_npy, gt_masks, min_px=(cam.width * cam.height) // 400)
        exported = sorted(f for f in os.listdir(out) if f.startswith(("poses-", "cloud-")))
        rc = view.main(["--export", out, "--no-png"])
        html = os.path.getsize(os.path.join(out, "view.html")) if rc == 0 else 0

        klg = os.path.join(root, "static.klg")
        write_klg(klg, static_frames[:n_static], cam.width, cam.height)
        cal = os.path.join(ds, "calibration.txt")
        gt_static = os.path.join(root, "gt_static.npy")
        np.save(gt_static, np.stack(static_gt[:n_static]))
        out_s = os.path.join(root, "out_static")
        s_wall_ms, s_launches, _, s_eng = _cli_run(
            ["-l", klg, "-cal", cal, "-static", "-run", "-q", "-d", "4.5", "-ep", "-exportdir", out_s],
            n_static, device)
        del s_eng
        s_score = _score(out_s, gt_static)
    finally:
        for m, mod in hidden.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    spawns = sorted(f for f, kind, _ in events if kind == "new")
    models = sorted({int(f.split("-")[1].split(".")[0]) for f in exported})
    _phase("cli", dataset=f"{n} frames {cam.width}x{cam.height} PNG", mode="multi-model CRF",
           flags=" ".join(CLI_FLAGS + ["-pngScale", "0.001", "-ep", "-es", "-em"]),
           ate_rmse_m=score.get("ate_rmse_m"), mean_iou=score.get("mean_iou"),
           per_object_iou={k: round(v["iou"], 4) for k, v in score.get("per_object_iou", {}).items()},
           iou_gate="reported only (ROADMAP C1)", spawn_events_at=spawns,
           spawn_frame_of_active_slot=spawned_at, models_exported=models, files=len(exported),
           view_html_bytes=html, png_decode_ms_per_frame=f"{color_ms + depth_ms:.3f}",
           png_decode_color_ms=f"{color_ms:.3f}", png_decode_depth16_ms=f"{depth_ms:.3f}",
           wall_ms_per_frame=f"{wall_ms:.3f}", launches=launches, dataset_write_s=f"{write_s:.1f}",
           cv2_and_matplotlib="unimportable")
    _phase("cli_static", log=f"{n_static} frames raw-RGB .klg", ate_rmse_m=s_score["ate_rmse_m"],
           traj_frames=s_score["traj_frames"], wall_ms_per_frame=f"{s_wall_ms:.3f}", launches=s_launches)
    for name, got, frames_run in (("multi", launches, n), ("static", s_launches, n_static)):
        if got["bilateral_filter"] != frames_run or got["splat_window"] < frames_run - 1:
            raise RuntimeError(f"CLI {name} run: kernel launches {got}, expected the bilateral "
                               f"{frames_run} times and the splat at least {frames_run - 1}")
    if "ate_rmse_m" not in score or score.get("traj_frames") != n or "mean_iou" not in score:
        raise RuntimeError(f"the CLI run could not be scored: {score}")
    if 0 not in models or rc != 0 or not html:
        raise RuntimeError(f"exports {exported}, view rc {rc}")
    if s_score["traj_frames"] != n_static or not s_score["ate_rmse_m"] < 0.01:
        raise RuntimeError(f"static CLI run: {s_score} (ATE must be below 1 cm)")
    shutil.rmtree(root, ignore_errors=True)
    return launches


# --- the sharded step (cofusion_tpu_torch/parallel): both tiers' surfel
# axes over a 4-device mesh, bit for bit the unsharded step
SHARDS = 4
SHARD_STATIC_FRAMES = 16  # phase 4's first 16 frames: depth cut to make room for the loop cells
SHARD_MULTI_FRAMES = 26  # the bench workload through its first spawn (frame 19) and 6 more
SHARD_MULTI_WINDOW = 20  # frames 21-26: object slots track and fuse
SHARD_DRIFT_TD = 3  # the drift cell's time window: its stable tier fills
AGED_STAMP = 1.0  # the drift cell's old stamp (> 0: the map ages out into the stable tier)


def _device_profile(eng, frame):
    """Kernels launched and device busy ms (summed over the cards) for one
    more frame, from torch.profiler's device records alone (memory copies
    and sets are not counted as launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.process_frame(frame)
        _sync_all()
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sum(e.count for e in cuda if not e.key.startswith(("Memcpy", "Memset")))
    return kernels, sum(e.self_device_time_total for e in cuda) / 1e3


def _sync_all():
    """Wait for every card (a sharded step queues work on each shard's)."""
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def _allocated(peak: bool = False) -> int:
    """Bytes allocated (or the peak since the last reset) over every card."""
    import torch

    fn = torch.cuda.max_memory_allocated if peak else torch.cuda.memory_allocated
    return sum(fn(d) for d in range(torch.cuda.device_count()))


def _reset_peaks():
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(d)


def _sharded_run(make_engine, frames, start, mesh=None, hooks=None, zero_last=True,
                 record_maps=False, probe=None):
    """Frames through process_frame (sharded after the first where `mesh`
    is given); with `zero_last` the last at time delta 0 (its surfels age
    out into the stable tier); `hooks` maps a frame index to a function of
    the engine run before that frame; frames start+1..N under the sync
    check (a hook runs outside it), timed as one window.  Returns the
    engine, its kernel launches, events, window ms per frame, its own peak
    memory (over the first frame with the sharding's copy of the state,
    and over the frames after), per frame `probe(eng)` (device values read
    after the run; default `lost` and `loop_closed`) and, with
    `record_maps`, the combined index maps the step before the last one
    splatted."""
    import torch

    from cofusion_tpu_torch.ops import rasterize as rz
    from cofusion_tpu_torch.parallel import shard_engine_state

    hooks = hooks or {}
    probe = probe or (lambda e: (e.state.lost, e._last_outputs.loop_closed))
    eng = make_engine()
    events = _listen(eng)
    _sync_all()
    base = _allocated()
    _reset_peaks()
    last, probes = {}, []
    splat = rz.splat_from_imap

    def recorded(imap, cam, cfg, conf_threshold=None):
        # kept: the maps of the frame before the last (the time-delta-0
        # frame renders only its own new, unconfident surfels)
        last["before"] = last.get("now")
        last["now"] = dict(imap=imap, conf_threshold=conf_threshold)
        return splat(imap, cam, cfg, conf_threshold=conf_threshold)

    _zero_counts()
    if record_maps:
        rz.splat_from_imap = recorded
    try:
        for i, f in enumerate(frames):
            if i in hooks:
                torch.cuda.set_sync_debug_mode("default")
                hooks[i](eng)
            if i == start:
                _sync_all()
                t0 = time.perf_counter()
            if i >= start:
                torch.cuda.set_sync_debug_mode("error")
            if zero_last and i == len(frames) - 1:
                eng._fparams["time_delta"] = 0
            eng.process_frame(f)
            if i == 0:
                if mesh is not None:
                    eng.state = shard_engine_state(eng.state, mesh)
                _sync_all()
                peak_first = _allocated(peak=True) - base
                _reset_peaks()
            else:
                probes.append(probe(eng))
        torch.cuda.set_sync_debug_mode("default")
    finally:
        torch.cuda.set_sync_debug_mode("default")
        rz.splat_from_imap = splat
    _sync_all()
    window_ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - start)
    launches = _read_counts()
    peak = (peak_first, _allocated(peak=True) - base)
    eng._fparams["time_delta"] = eng.cfg.time_delta
    eng.flush_lifecycle()
    probes = [tuple(v.item() for v in p) for p in probes]
    return dict(engine=eng, launches=launches, events=events, window_ms=window_ms, peak=peak,
                maps=last.get("before"), probes=probes)


def _whole_state(eng):
    """The engine's state with both tiers gathered, every tensor on the host."""
    import torch

    from cofusion_tpu_torch.parallel import unshard_engine_state

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, tuple):
            return type(x)(*(host(a) for a in x))
        return x

    return host(unshard_engine_state(eng.state))


def _same_state(a, b, path="state"):
    """Names of the leaves of two host states that differ."""
    import torch

    if isinstance(a, tuple):
        names = getattr(a, "_fields", range(len(a)))
        return [d for k, x, y in zip(names, a, b) for d in _same_state(x, y, f"{path}.{k}")]
    if isinstance(a, torch.Tensor):
        return [] if a.dtype == b.dtype and torch.equal(a, b) else [path]
    return [] if a == b else [path]


def _splat_on_maps(maps, cfg, cam):
    """The splat kernel against its plain version, bit for bit, on combined
    index maps the sharded step splatted (as splat_from_imap passes them;
    the check's launch is not the path's)."""
    import torch

    from cofusion_tpu_torch.ops import cuda_splat

    imap, thr = maps["imap"], maps["conf_threshold"]
    valid = imap.valid & (imap.vert_conf[..., 3] >= thr.reshape(-1, 1, 1))
    args = (imap.vert_conf[..., :3], imap.normal_rad[..., :3], imap.normal_rad[..., 3], valid,
            cfg.splat_radius, (cam.fx, cam.fy, cam.cx, cam.cy))
    n = cuda_splat.splat_window_cuda.launches
    z_k, tap_k = cuda_splat.splat_window_cuda(*args)
    cuda_splat.splat_window_cuda.launches = n
    z_p, tap_p = cuda_splat.splat_window_plain(*args)
    torch.cuda.synchronize()
    mism = int((tap_k != tap_p).sum())
    row = dict(shape=tuple(valid.shape), valid_pixels=int(valid.sum()), tap_mismatches=mism,
               max_abs_z_err=_max_err(z_k, z_p))
    if mism or not torch.equal(z_k, z_p) or not row["valid_pixels"]:
        raise RuntimeError(f"splat kernel on the sharded step's maps: {row}")
    return row


def _loop_block_cost(eng) -> dict:
    """The loop block ('-cl': three window splats, the local loop, graph
    sampling over both tiers, the graph solve, both tiers warped and
    re-stamped, the tier exchange; with '-rl', its fern candidate) called
    on the engine's final state, sharded or not: device busy ms and kernels
    per call (torch.profiler's device records over 2 calls, summed over the
    cards) and its own peak memory over the cards and on the first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import cofusion_tpu_torch.engine as em

    st, cfg, cam = eng.state, eng.cfg, eng.cam
    fp = dict(eng._fparams, weight_multiplier=1.0)
    pose0, conf0, tick = st.models.pose[0], st.models.conf_threshold[0], st.tick + 1
    fern = None
    if eng.enable_relocalization:
        A0 = torch.eye(6, device=pose0.device) * 1e6
        fern = em._relocalise(st._replace(fern_db=_tree_to(st.fern_db, pose0.device)), A0,
                              pose0, st.prev_rgb, st.prev_filtered, cam, cfg, eng.tracking, fp,
                              tick)[4]
    store0, stable0 = em._slot0(st.models.store), em._slot0(st.models.stable)

    def close():
        s = st._replace(pose_history=st.pose_history.clone())
        return em._close_loop(s, store0, stable0, pose0, conf0, st.lost, fern, cam, cfg,
                              eng.tracking, fp, tick)

    close()
    _sync_all()
    base, base0 = _allocated(), torch.cuda.memory_allocated(pose0.device)
    _reset_peaks()
    out = close()
    _sync_all()
    peak = _allocated(peak=True) - base
    peak0 = torch.cuda.max_memory_allocated(pose0.device) - base0
    del out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            close()
        _sync_all()
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sum(e.count for e in cuda if not e.key.startswith(("Memcpy", "Memset"))) / 2
    busy = sum(e.self_device_time_total for e in cuda) / 1e3 / 2
    return dict(loop_block_device_ms=busy, loop_block_kernels=kernels,
                loop_block_peak_bytes=peak, loop_block_peak_bytes_first_card=peak0)


def _stable_valid(eng):
    """Slot 0's valid stable surfels (a device value, on the counts' device)."""
    from cofusion_tpu_torch.models import surfel_model as sm

    st = eng.state.models.stable
    dev = st.count.device
    return sum(sm.to_device(s.valid[0].sum(), dev) for s in sm.shards_of(st)[0])


def _sharded_cell(cell, make, frames, start, mesh, expect, hooks=None, zero_last=True,
                  after=None, probe=None):
    """One cell run unsharded and sharded in this call (see `_sharded_run`):
    the kernel launches must equal `expect`; `after(eng)` measures each
    run's final engine (a dict); then one more frame under torch.profiler.
    Poses, both tiers of every slot gathered, counts, flags, the fern
    database, the rings, events, (CRF) masks and each frame's probes must
    be bit-identical.  Prints the cell's line and returns both runs."""
    import numpy as np
    import torch

    n = len(frames)
    runs = {}
    for kind, m in (("unsharded", None), ("sharded", mesh)):
        run = _sharded_run(make, frames, start, m, hooks, zero_last, cell == "bench", probe)
        eng = run["engine"]
        if run["launches"] != expect:
            raise RuntimeError(f"[sharded] {cell} {kind}: kernel launches {run['launches']}, "
                               f"expected {expect}")
        run.update(state=_whole_state(eng), poses=[p for _, p in eng.pose_log],
                   events=list(run["events"]),
                   masks=dict(eng.drain_segmentation(flush=True)) if cell == "bench" else {})
        if m is not None and cell == "bench":
            run["splat"] = _splat_on_maps(run["maps"], eng.cfg, eng.cam)
        run["after"] = after(eng) if after is not None else {}
        run["kernels"], run["busy_ms"] = _device_profile(eng, frames[-1])
        runs[kind] = run
        del eng, run["engine"], run["maps"]
        torch.cuda.empty_cache()
    ref, got = runs["unsharded"], runs["sharded"]
    diff = _same_state(got["state"], ref["state"])
    poses_equal = all(np.array_equal(a, b) for a, b in zip(got["poses"], ref["poses"]))
    masks_equal = got["masks"].keys() == ref["masks"].keys() and all(
        np.array_equal(got["masks"][t], ref["masks"][t]) for t in ref["masks"])
    st = ref["state"].models
    extra = {k: f"{v} / {ref['after'][k]}" if k in ref["after"] else v
             for k, v in got["after"].items()}
    _phase("sharded", cell=cell, frames=n, window=f"{start + 1}-{n}",
           launches_per_frame={k: v / n for k, v in got["launches"].items()},
           kernel_launches_per_frame=f"{got['kernels']} sharded / {ref['kernels']} unsharded",
           device_busy_ms_per_frame=f"{got['busy_ms']:.3f} / {ref['busy_ms']:.3f}",
           steady_ms_per_frame=f"{got['window_ms']:.3f} / {ref['window_ms']:.3f}",
           own_peak_bytes_frame1=f"{got['peak'][0]} / {ref['peak'][0]}",
           own_peak_bytes_after=f"{got['peak'][1]} / {ref['peak'][1]}",
           state="bit-identical" if not diff else f"differs at {diff[:6]}",
           poses="bit-identical" if poses_equal else "differ",
           masks=("bit-identical" if masks_equal else "differ") if cell == "bench" else "n/a",
           probes_equal=got["probes"] == ref["probes"],
           events=got["events"], events_equal=got["events"] == ref["events"],
           active=st.active.int().tolist(), active_count=st.store.count.tolist(),
           stable_count=st.stable.count.tolist(), sync_debug=f"error on frames {start + 1}-{n}",
           **extra)
    if (diff or not poses_equal or not masks_equal or got["events"] != ref["events"]
            or got["probes"] != ref["probes"]):
        raise RuntimeError(f"[sharded] {cell}: the sharded run differs from the unsharded one")
    return runs


def _sharded_render_views(t5, mesh):
    """`render_views` on phase 15's '-t 5 -confG 1.5' map, unsharded and
    then sharded: views bit-identical, 2 splats a call, the splat bit-equal
    to its plain version on the sharded tiers' own index maps; device ms
    (torch.profiler over 2 calls) and wall ms of a call."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cofusion_tpu_torch.parallel import shard_engine_state

    out = {}
    for kind in ("unsharded", "sharded"):
        if kind == "sharded":
            t5.state = shard_engine_state(t5.state, mesh)
        _sync_all()
        _zero_counts()
        views = t5.render_views()
        launches = _read_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                t5.render_views()
            _sync_all()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / 2
        t0 = time.perf_counter()
        t5.render_views()
        out[kind] = dict(views=views, launches=launches, busy_ms=busy,
                         wall_ms=(time.perf_counter() - t0) * 1e3)
    m = t5.state.models
    rows = _splat_on_views(t5, [("active tier", m.store, t5.cfg.time_delta, True),
                                ("stable tier", m.stable, 1 << 30, True)])
    got, ref = out["sharded"], out["unsharded"]
    same = all(np.array_equal(got["views"][k], ref["views"][k]) for k in ref["views"])
    _phase("sharded", cell="render_views", state="-t 5 -confG 1.5, 30 orbit frames",
           views="bit-identical" if same else "differ",
           valid_pixels=int(ref["views"]["valid"].sum()),
           launches_per_call=f"{got['launches']} sharded / {ref['launches']} unsharded",
           device_ms_per_call=f"{got['busy_ms']:.3f} / {ref['busy_ms']:.3f}",
           wall_ms_per_call=f"{got['wall_ms']:.3f} / {ref['wall_ms']:.3f}")
    for row in rows:
        _phase("kernels", kernel="splat_window", on="render_views, sharded", **row, bar="bit-equal")
    if not same or got["launches"]["splat_window"] != 2 or not ref["views"]["valid"].any():
        raise RuntimeError(f"[sharded] render_views: views {same}, launches {got['launches']}")
    if not rows[1]["valid_pixels"]:
        raise RuntimeError("[sharded] render_views: the stable tier's view is empty")
    return got["launches"]


def phase_sharded(dev, static_frames, crf_frames, drift_frames, drift_gt, t5=None):
    """On a 4-shard mesh, each run against the unsharded run of the same
    call: the static cell's first 16 frames and the bench workload's first 26
    (its first spawn at frame 19, then 6 more; each run's last frame at
    time delta 0); phase 10's `-static -rl -cl` cell (20 frames); phase
    11's drift at time delta 3 (the stable tier fills, a loop closes with
    surfels in both tiers); phase 12's blackout (lost, then recovered);
    and `render_views` on phase 15's '-t 5' map.  Every pose, both tiers
    of every slot, counts, flags, the fern database, the rings, lifecycle
    events, (CRF) masks and views bit-identical; the kernels' launches as
    unsharded; the splat bit-equal to its plain version on the sharded
    step's own combined maps, the sharded loop block's and
    `render_views`'; kernel launches, device busy ms, steady ms per frame
    and each run's own peak memory, and the loop block's device ms and
    peak memory, sharded and unsharded.  Returns the kernel launches of
    the sharded bench and '-rl -cl' runs and of one sharded
    `render_views` call."""
    import numpy as np
    import torch

    from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams
    from cofusion_tpu_torch.engine import CoFusion
    from cofusion_tpu_torch.models import surfel_model as sm
    from cofusion_tpu_torch.parallel import make_mesh

    mesh = make_mesh(SHARDS, "cuda", virtual=torch.cuda.device_count() < SHARDS)
    cards = [f"{d}: {torch.cuda.get_device_name(d)}" for d in mesh.distinct_devices]
    _phase("sharded", shards=SHARDS, mesh=[str(d) for d in mesh.devices], distinct_cards=cards,
           virtual=torch.cuda.device_count() < SHARDS)

    def once_a_frame(n):
        return {"bilateral_filter": n, "splat_window": n}

    def loop_splats(n):  # the init render, then 4 splats a frame
        return {"bilateral_filter": n, "splat_window": 1 + 4 * (n - 1)}

    frames = static_frames[:SHARD_STATIC_FRAMES]
    runs = _sharded_cell("static", lambda: _engine(dev), frames, 2, mesh,
                         once_a_frame(len(frames)))
    if not (runs["unsharded"]["state"].models.stable.count > 0).any():
        raise RuntimeError("[sharded] static: no expel into the stable tier")
    bench_frames = crf_frames[:SHARD_MULTI_FRAMES]
    runs = _sharded_cell("bench", lambda: _multi_engine(dev), bench_frames, SHARD_MULTI_WINDOW,
                         mesh, once_a_frame(len(bench_frames)))
    _phase("sharded", cell="bench", splat_on_sharded_maps=runs["sharded"]["splat"], bar="bit-equal")
    launches_bench = runs["sharded"]["launches"]
    st = runs["unsharded"]["state"].models
    if not (st.stable.count > 0).any() or not st.active[1:].any():
        raise RuntimeError("[sharded] bench: no expel into the stable tier, or no object slot")

    # (a) '-static -rl -cl': the loop block's cost on each run's final state
    def loop_after(eng):
        out = _loop_block_cost(eng)
        if isinstance(eng.state.models.store, sm.ShardedStore):
            out["splat_on_loop_maps"] = _splat_on_loop_maps(eng)
        return out

    frames = static_frames[:LOOP_FRAMES]
    runs = _sharded_cell("rl_cl", lambda: _loop_engine(dev), frames, 2, mesh,
                         loop_splats(len(frames)), zero_last=False, after=loop_after)
    launches_loop = runs["sharded"]["launches"]
    if any(lost for lost, _ in runs["unsharded"]["probes"]):
        raise RuntimeError("[sharded] rl_cl: the orbit was lost")

    # (b) the drift at time delta 3: the map stamped old (it ages out into
    # the stable tier) and the camera drifted after frame 6
    n_warm = 6

    def drift_after(eng):
        err = float(np.linalg.norm(eng.camera_pose()[:3, 3] - drift_gt[-1][:3, 3]))
        out = dict(_loop_block_cost(eng), camera_err_m=f"{err:.6f}")
        if isinstance(eng.state.models.store, sm.ShardedStore):
            out["splat_on_loop_maps"] = _splat_on_loop_maps(eng)
        return out

    runs = _sharded_cell(
        "drift", lambda: _loop_engine(dev, reloc=False, time_delta=SHARD_DRIFT_TD, **LOOP_FUSION),
        drift_frames, 2, mesh, loop_splats(len(drift_frames)),
        hooks={n_warm: lambda e: _age_and_drift(e, AGED_STAMP)}, zero_last=False,
        after=drift_after,
        probe=lambda e: (e.state.lost, e._last_outputs.loop_closed, _stable_valid(e)))
    probes = runs["unsharded"]["probes"]
    closed_at = [k for k, p in enumerate(probes, 1) if p[1]]
    stable_at = {k: probes[k - 2][2] for k in closed_at}  # before the closing frame
    moved = {k: probes[k - 2][2] - probes[k - 1][2] for k in closed_at}
    _phase("sharded", cell="drift", closed_at_frames=closed_at,
           stable_valid_before_closing=stable_at, stable_rows_moved_to_active=moved,
           bar="a closure fires with a non-empty stable tier")
    if not closed_at or not all(stable_at.values()):
        raise RuntimeError(f"[sharded] drift: closures at {closed_at}, stable tier {stable_at}")

    # (c) the blackout: lost in it, recovered after it
    cam = CameraConfig()
    frames = _blackout_frames(cam)
    runs = _sharded_cell("blackout",
                         lambda: _loop_engine(dev, close=False, fern_min_age=3,
                                              confidence_global=1.0),
                         frames, 2, mesh, once_a_frame(len(frames)), zero_last=False)
    lost = [bool(p[0]) for p in runs["unsharded"]["probes"]]
    _phase("sharded", cell="blackout", lost_frames=[k for k, x in enumerate(lost, 1) if x],
           bar="lost in the blackout, recovered after it")
    if any(lost[:5]) or not any(lost[5:19]) or lost[-1]:
        raise RuntimeError(f"[sharded] blackout: lost {lost}")

    # (d) render_views on phase 15's map
    if t5 is None:
        t5 = CoFusion(CoFusionConfig(camera=cam, max_models=1, time_delta=5),
                      fusion_params=FusionParams(depth_cutoff=4.5, confidence_global=1.5), device=dev)
        for f in static_frames:
            t5.process_frame(f)
    launches_render = _sharded_render_views(t5, mesh)
    return launches_bench, launches_loop, launches_render


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="also time the kernels built from the .cu files in DIR")
    ap.add_argument("--only", metavar="GROUPS",
                    help="run only these comma-separated groups of phases (kernels, static, "
                         "multi, loop, surfaces, cli, sharded) and print no result lines: for "
                         "development")
    opts = ap.parse_args(argv)
    groups = (set(opts.only.split(",")) if opts.only
              else {"kernels", "static", "multi", "loop", "surfaces", "cli", "sharded"})
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from cofusion_tpu_torch.config import CameraConfig
    from cofusion_tpu_torch.device import resolve_device
    from cofusion_tpu_torch.io.synthetic import make_multi_object_frames, make_sequence
    from cofusion_tpu_torch.ops import _build

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    dev = resolve_device("cuda")
    smi = _nvidia_smi()
    import importlib.util

    _phase("device", nvidia_smi=repr(smi), name=repr(torch.cuda.get_device_name(0)),
           count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
           cv2_importable=importlib.util.find_spec("cv2") is not None,
           matplotlib_importable=importlib.util.find_spec("matplotlib") is not None)

    lib = _build.load()
    ptxas = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln or "bytes smem" in ln]
    _phase("build", seconds=f"{lib.seconds:.2f}", built=lib.built, library=os.path.relpath(lib.path, REPO))
    for ln in ptxas:
        print("  ptxas: " + ln)

    t0 = time.perf_counter()
    frames, gt, _ = make_sequence(CameraConfig(), 30)
    _phase("frames", n=len(frames), shape=frames[0]["depth"].shape,
           seconds=f"{time.perf_counter() - t0:.1f}")

    cam = CameraConfig()
    if "kernels" in groups:
        kern = phase_kernels(dev, frames[0]["depth"], opts.baseline)
    static_eng = t5 = None
    if "static" in groups:
        launches_static, static_eng = phase_main_path(dev, frames, gt)
        phase_timing(lambda: _engine(dev), frames, static_eng)
        phase_parity()

    if "multi" in groups:
        t0 = time.perf_counter()
        unique = make_multi_object_frames(cam, 12, masks=True)
        gt_ids = [f["mask"] for f in unique]
        crf_frames = [dict(unique[i % 12], mask=None, timestamp=i) for i in range(MULTI_FRAMES)]
        _phase("frames", n=len(crf_frames), unique=len(unique), objects=3,
               seconds=f"{time.perf_counter() - t0:.1f}")
        launches_multi, eng, masks, first_spawn = phase_multi_crf(dev, crf_frames, gt_ids)
        # time the frames after the first spawn: object slots track and fuse
        steady_ms, _, eng2 = phase_timing(lambda: _multi_engine(dev), crf_frames, eng, masks,
                                          tag="multi_timing", start=first_spawn + 1)
        del eng
        phase_idle_slot(eng2, steady_ms)
        del eng2
        phase_gt_masks(dev, unique)
        phase_parity_multi()

    if "loop" in groups:
        launches, eng = phase_loop_path(dev, frames, gt)
        phase_timing(lambda: _loop_engine(dev), frames[:LOOP_FRAMES], eng, tag="loop_timing")
        phase_loop_blocks(eng)
        del eng
        drift_frames, drift_gt, _ = make_sequence(cam, 10, kind="still")
        phase_loop_closure(dev, drift_frames, drift_gt)
        phase_reloc(dev)
        phase_loop_parity()

    if "surfaces" in groups:
        launches_gt_pose = phase_gt_pose(dev, frames, gt)
        launches_render, t5 = phase_render_views(dev, frames, static_eng)
        del static_eng
        phase_checkpoint(dev, frames)
        phase_hot_params(dev)

    if "cli" in groups:
        unique = make_multi_object_frames(cam, 12, masks=True)
        launches_cli = phase_cli(cam, unique, frames, gt)

    if "sharded" in groups:
        unique = make_multi_object_frames(cam, 12)
        crf_frames = [dict(unique[i % 12], mask=None, timestamp=i) for i in range(SHARD_MULTI_FRAMES)]
        drift_frames, drift_gt, _ = make_sequence(cam, 10, kind="still")
        launches_sharded, launches_sharded_loop, launches_sharded_render = phase_sharded(
            dev, frames, crf_frames, drift_frames, drift_gt, t5)
    del t5
    _phase("done", seconds=f"{time.perf_counter() - _T0:.1f}")

    if opts.only:
        return 0
    sources = {
        "bilateral_filter": ("cofusion_tpu_torch/csrc/bilateral.cu", "cofusion_tpu/ops/pallas_stencil.py:75"),
        "splat_window": ("cofusion_tpu_torch/csrc/splat_window.cu", "cofusion_tpu/ops/pallas_splat.py:116"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "launches_multi": launches_multi[name],
         "launches_static": launches_static[name], "launches_gt_pose": launches_gt_pose[name],
         "launches_render": launches_render[name], "launches_cli": launches_cli[name],
         "launches_sharded": launches_sharded[name],
         "launches_sharded_loop": launches_sharded_loop[name],
         "launches_sharded_render": launches_sharded_render[name], **kern[name]}
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
