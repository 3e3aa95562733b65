"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

One `nvcc` per source, all started together, compiles `csrc/*.cu` to
objects, and one more links them into `_build/libsrcfd_kernels.so`, a
shared library with a plain C interface, which is loaded with `ctypes`.
The build runs at first use, takes seconds, and is skipped while the
library is newer than every source. Nothing here runs at import time, so
the package imports on machines without CUDA.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libsrcfd_kernels.so"
# -fmad=false: no multiply-add is contracted, so each kernel rounds
# operation by operation as its plain PyTorch version does (explicit
# fmaf() calls stay fused)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer (and the stream) as c_void_p
SIGNATURES = {
    "srcfd_rb_partials": (_I, [_I, _I]),
    "srcfd_rb_small_max_cells": (_I, []),
    "srcfd_rb_half_sweep": (_I, [_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F,
                                 _I, _I, _I, _P]),
    "srcfd_rms_finalize": (_I, [_P, _I, _F, _P, _P]),
    "srcfd_rb_sor_loop_small": (_I, [_P, _P, _I, _I, _F, _F, _F, _F, _F,
                                     _F, _I, _F, _F, _I, _I, _F, _I, _I,
                                     _P, _P, _P]),
    "srcfd_stream_sync": (_I, [_P]),
    "srcfd_rb_warp_params_size": (_I, []),
    "srcfd_rb_sor_warp": (_I, [_P] * 9),
    "srcfd_mg_partials": (_I, [_I, _I]),
    "srcfd_mg_smooth_half": (_I, [_P, _P, _I, _I, _F, _F, _F, _F, _I, _P]),
    "srcfd_mg_residual": (_I, [_P, _P, _P, _P, _I, _I, _F, _F, _F, _P]),
    "srcfd_mg_row_transfer": (_I, [_P, _P, _I, _I, _I, _I, _P, _P, _P, _F,
                                   _I, _P]),
    "srcfd_mg_col_transfer": (_I, [_P, _P, _I, _I, _I, _P, _P, _P, _F, _I,
                                   _P]),
    "srcfd_mg_zero": (_I, [_P, _I, _P]),
    "srcfd_mg_tail_init": (_I, []),
    "srcfd_mg_tail": (_I, [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P]),
    "srcfd_step_small_fits": (_I, [_I, _I]),
    "srcfd_step_small_init": (_I, []),
    "srcfd_step_small_batched": (_I, [_P] * 21 + [_I, _P]),
    "srcfd_step_mom_partials": (_I, [_I, _I]),
    "srcfd_step_proj_partials": (_I, [_I, _I]),
    "srcfd_step_mom_half": (_I, [_P] * 9 + [_I, _P, _P]),
    "srcfd_step_relax": (_I, [_P, _P, _I, _I, _F, _P]),
    "srcfd_step_bc": (_I, [_P, _I, _P, _P, _P, _P]),
    "srcfd_step_fluxes": (_I, [_P] * 8),
    "srcfd_step_project": (_I, [_P] * 13),
    "srcfd_step_sums": (_I, [_P, _I, _P, _P]),
    "srcfd_step_relax_bc": (_I, [_P, _P, _P, _F, _I, _I, _P, _P, _P, _P]),
    "srcfd_step_project_bc": (_I, [_P] * 17),
    "srcfd_mom_pass_params_size": (_I, []),
    "srcfd_mom_pass_init": (_I, []),
    "srcfd_mom_pass": (_I, [_P] * 11),
    "srcfd_tm_half": (_I, [_P] * 8 + [_I, _I, _I, _F, _F, _F, _F, _F, _I,
                                      _P, _P]),
    "srcfd_sm_entry_half": (_I, [_P, _P, _P, _I, _I, _F, _F, _F, _F, _P, _P]),
    "srcfd_sm_restrict_rows": (_I, [_P, _P, _P, _I, _I, _I, _F, _F, _F, _I,
                                    _F, _F, _P]),
    "srcfd_shard_rb_partials": (_I, [_I, _I]),
    "srcfd_shard_rb_sweep": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                  _F, _F, _F, _I, _P]),
    "srcfd_tiled_rb_sweep": (_I, [_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F,
                                  _P]),
    "srcfd_sum_finalize": (_I, [_P, _I, _P, _P]),
    "srcfd_shard_rb_params_size": (_I, []),
    "srcfd_shard_rb_init": (_I, []),
    "srcfd_shard_rb_fused": (_I, [_P, _P, _P, _P, _P, _I, _P]),
    "srcfd_stream_pass_params_size": (_I, []),
    "srcfd_stream_pass_init": (_I, []),
    "srcfd_stream_pass": (_I, [_P] * 8),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "from source at first use")
    return found


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _up_to_date() -> bool:
    if not LIB_PATH.exists():
        return False
    newest = max(p.stat().st_mtime for p in CSRC_DIR.iterdir())
    return LIB_PATH.stat().st_mtime > newest


def build(force: bool = False, verbose: bool = False) -> float:
    """Compile `csrc/*.cu` into the shared library unless it is up to date.
    Returns the seconds spent. `verbose` adds `-Xptxas -v` and prints the
    compiler's report (registers, shared memory, spills per kernel)."""
    if not force and _up_to_date():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = BUILD_DIR / f"libsrcfd_kernels.{tag}.so"
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, failed = [], None
    for cmd, _, proc in jobs:
        try:
            out, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        report.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, out)
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed is not None:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{' '.join(failed[1])}\n"
                               f"{failed[2]}")
        cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    if verbose:
        print("".join(report), flush=True)
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent build never sees half a file
    return time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The kernel library, built if needed, with argtypes set and the
    dynamic shared memory of the V-cycle tail, of the fused step's design
    (a), of the tiled red-black kernel's fused form, of the fused momentum
    pass and of the fused streamed passes allowed (before any launch or
    graph capture)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            check(lib.srcfd_mg_tail_init(), "mg_tail_init")
            check(lib.srcfd_step_small_init(), "step_small_init")
            check(lib.srcfd_shard_rb_init(), "shard_rb_init")
            check(lib.srcfd_mom_pass_init(), "mom_pass_init")
            check(lib.srcfd_stream_pass_init(), "stream_pass_init")
            from . import mom_pass, pressure_kernels, shard_rb, stream_pass

            for mod, struct, size in (
                    (pressure_kernels, "RbWarpParams", lib.srcfd_rb_warp_params_size),
                    (shard_rb, "ShardRbParams", lib.srcfd_shard_rb_params_size),
                    (mom_pass, "MomPassParams", lib.srcfd_mom_pass_params_size),
                    (stream_pass, "StreamPassParams", lib.srcfd_stream_pass_params_size)):
                if size() != ctypes.sizeof(mod.Params):
                    raise RuntimeError(
                        f"{mod.__name__}'s Params ({ctypes.sizeof(mod.Params)} bytes) "
                        f"does not match the C struct {struct} ({size()} bytes)")
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA error {code} launching {what}")


def stream_ptr(device) -> int:
    """The current stream of `device` as a pointer (without making a
    torch.cuda.Stream, which costs a few microseconds a call)."""
    import torch

    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def check_field(p, kernel: str, shape=None) -> None:
    """Raise unless `p` is what the pressure kernels take: a contiguous
    float32 (nx+2, ny+2) field on a CUDA device, or of exactly `shape`
    where one is given."""
    import torch

    if (p.is_cuda and p.dtype is torch.float32 and p.is_contiguous()
            and (p.dim() == 2 and min(p.shape) >= 3 if shape is None else p.shape == shape)):
        return  # the common case, in a few attribute reads
    if p.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {p.device}")
    if p.dtype != torch.float32:
        raise ValueError(f"the {kernel} kernel is float32-only, got {p.dtype}")
    if shape is not None:
        if tuple(p.shape) != tuple(shape):
            raise ValueError(f"the {kernel} kernel takes a {tuple(shape)} tensor, "
                             f"got {tuple(p.shape)}")
    elif p.dim() != 2 or min(p.shape) < 3:
        raise ValueError(f"expected a padded (nx+2, ny+2) field, got {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError(f"the {kernel} kernel takes a contiguous (row-major) "
                         f"field, got strides {p.stride()}")
