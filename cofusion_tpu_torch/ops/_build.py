"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` for Hopper (`sm_90a`),
all started together, and the objects are linked into ONE shared library
with a plain C interface, loaded with `ctypes`.  The library is built at
first use into `cofusion_tpu_torch/_build/`, named by a hash of the sources
and the flags, so a changed source rebuilds and an unchanged one loads in
milliseconds.  Nothing here runs at import time: the CPU tests import every
module on a machine without `nvcc`.

Numerics flags: no fast math (precise `expf`, IEEE division and `sqrtf`), and
`-fmad=false` so no multiply-add is contracted into an FMA — the splat's ray
build and `t*l - p` would otherwise move a hit across a 1/4096 depth bucket
and flip winners against the plain PyTorch version.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; the Python wrappers raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: (argtypes); every one returns the launch's cudaError_t
SIGNATURES = {
    # depth, out, H, W, max_depth, stream
    "cofusion_bilateral_f32": (_P, _P, _I, _I, _F, _P),
    # pos, norm, rad, valid, strides (12 x int64: batch/row/pixel of each input),
    # best_z (B,H,W), best_tap (B,H,W), B, H, W, r, fx, fy, cx, cy, stream
    "cofusion_splat_window_f32": (
        _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
        _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P,
    ),
}


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    built: bool          # True if this process ran nvcc
    seconds: float       # build (or load) wall time
    log: str             # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def sources(csrc: Path = CSRC_DIR) -> list[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def _source_hash(srcs: list[Path]) -> str:
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(srcs: list[Path], signatures: dict) -> KernelLibrary:
    """Build (if needed) the library of `srcs` into BUILD_DIR and load it,
    declaring `signatures` (C name -> argtypes; every one returns an int)."""
    t0 = time.perf_counter()
    so = BUILD_DIR / f"libcofusion_kernels_{_source_hash(srcs)}.so"
    built, log = False, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        nvcc = _nvcc()
        cu = [p for p in srcs if p.suffix == ".cu"]
        objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)] for p, o in zip(cu, objs)]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        try:
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in cmds]
            outs = [p.communicate()[0] for p in procs]
            log = "".join(outs)
            for cmd, proc, out in zip(cmds, procs, outs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                                   f"{proc.stdout}{proc.stderr}")
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        os.replace(tmp, so)
        built = True
    lib = ctypes.CDLL(str(so))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=so, built=built, seconds=time.perf_counter() - t0, log=log)


@functools.lru_cache(maxsize=1)
def load() -> KernelLibrary:
    """Build (if needed) and load the port's kernel library; cached per process."""
    return build(sources(), SIGNATURES)


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
