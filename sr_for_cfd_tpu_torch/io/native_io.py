"""ctypes loader and builder of the native `.dat` writer (the port's copy of
`sr_for_cfd_tpu/io/native_io.py`; source `io/native/fastdat.cpp`).

The library is built at first use with `g++ -O2 -shared -fPIC` into the
package's `_build/` directory (never next to the source), to a temporary
name renamed into place, so that a concurrent process never loads half a
file. Where no compiler or library is available, `append_field_sections`
returns False and `io/datfiles.save_full_field` writes the file in Python.

`used` counts the full-field bodies written by each writer ("native",
"python"), so that a run can show which one wrote its files.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "fastdat.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
LIB = BUILD_DIR / "_fastdat.so"
COMPILER = "g++"

used = {"native": 0, "python": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed: Optional[str] = None  # why the writer is unavailable


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([COMPILER, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed is not None:
        return _lib
    with _lock:
        if _lib is not None or _failed is not None:
            return _lib
        try:
            if not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(LIB))
            lib.append_field_sections.restype = ctypes.c_int
            lib.append_field_sections.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ]
            _lib = lib
        except Exception as e:  # noqa: BLE001 -- no toolchain: the Python writer
            _failed = f"{type(e).__name__}: {e}"
    return _lib


def unavailable() -> Optional[str]:
    """None when the native writer loads, else why it does not."""
    _load()
    return _failed


def append_field_sections(filename: str, var: np.ndarray) -> bool:
    """Append the per-variable sections of `var` (nvar, nx+2, ny+2) to
    `filename` through the native writer. False when it is unavailable or
    fails (the caller then writes the file in Python)."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(var, dtype=np.float64)
    nvar, nxp, nyp = arr.shape
    rc = lib.append_field_sections(
        os.fsencode(filename), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nvar, nxp, nyp)
    if rc == 0:
        used["native"] += 1
    return rc == 0
