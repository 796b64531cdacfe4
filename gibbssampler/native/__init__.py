"""Native (C++/OpenMP) table engine with lazy build and numpy fallback.

Compiled on first use with g++ into the user cache dir and loaded via ctypes
(the image has no pybind11; the reference's native layer was a Cython module
built by setup.py — reference: setup.py:1-6, variance_expension.pyx)."""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False


def _build_dir() -> pathlib.Path:
    d = pathlib.Path(os.environ.get("XDG_CACHE_HOME",
                                    os.path.expanduser("~/.cache")))
    d = d / "gibbssampler"
    d.mkdir(parents=True, exist_ok=True)
    return d


def load() -> ctypes.CDLL | None:
    """Compile (once) and load the native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = pathlib.Path(__file__).parent / "tables.cpp"
    out = _build_dir() / "libgibbstables.so"
    try:
        if (not out.exists()
                or out.stat().st_mtime < src.stat().st_mtime):
            cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                   "-fPIC", str(src), "-o", str(out)]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(out))
        lib.gs_legendre_table.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
        lib.gs_wigner_d_table.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
        _LIB = lib
    except Exception as e:  # pragma: no cover - depends on toolchain
        print(f"gibbssampler.native: build/load failed ({e}); "
              "using numpy fallback", file=sys.stderr)
        _LIB = None
    return _LIB


def legendre_table(lmax: int, x: np.ndarray) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    out = np.empty((lmax + 1, lmax + 1, x.shape[0]), dtype=np.float64)
    lib.gs_legendre_table(lmax, x.shape[0], x, out)
    return out


def wigner_d_table(lmax: int, s: int, beta: np.ndarray) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    beta = np.ascontiguousarray(beta, dtype=np.float64)
    out = np.empty((lmax + 1, lmax + 1, beta.shape[0]), dtype=np.float64)
    lib.gs_wigner_d_table(lmax, s, beta.shape[0], beta, out)
    return out
