"""Native (C++) planner core, bound via ctypes.

The reference's planning/validation layer is native host code; this module
provides the same here: planner.cpp compiled on first use with the system
toolchain into a shared library cached next to the source.  All
entry points have pure-Python fallbacks (planner.py / validation.py) — the
framework works without a compiler, just plans marginally slower.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "planner.cpp")
_LIB = os.path.join(_HERE, "libpfftplan.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(
        _SRC
    ):
        return True
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", _LIB, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        i64 = ctypes.c_int64
        p64 = ctypes.POINTER(ctypes.c_int64)
        lib.pf_prime_factorize.restype = ctypes.c_int
        lib.pf_prime_factorize.argtypes = [i64, p64, ctypes.c_int]
        lib.pf_largest_prime_factor.restype = i64
        lib.pf_largest_prime_factor.argtypes = [i64]
        lib.pf_factor_chain.restype = ctypes.c_int
        lib.pf_factor_chain.argtypes = [i64, ctypes.c_int, p64, ctypes.c_int]
        lib.pf_global_split.restype = ctypes.c_int
        lib.pf_global_split.argtypes = [
            i64, ctypes.c_int, i64, i64, i64, i64, i64, p64, p64
        ]
        lib.pf_overlap_check_1d.restype = i64
        lib.pf_overlap_check_1d.argtypes = [i64, i64, i64, i64]
        _lib = lib
        return _lib


def factor_chain(n: int, max_factor: int):
    """Native factor_chain; None for Bluestein sizes; raises RuntimeError if
    the native library is unavailable (caller falls back)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native planner unavailable")
    buf = (ctypes.c_int64 * 64)()
    cnt = lib.pf_factor_chain(n, max_factor, buf, 64)
    if cnt == 0:
        return None
    if cnt < 0:
        raise RuntimeError("factor chain overflow")
    return [int(buf[i]) for i in range(cnt)]


def global_split(
    n, max_factor, direct_threshold, fused_rows, itemsize, fused_budget,
    pass_budget,
):
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native planner unavailable")
    g1 = ctypes.c_int64()
    g2 = ctypes.c_int64()
    ok = lib.pf_global_split(
        n, max_factor, direct_threshold, fused_rows, itemsize, fused_budget,
        pass_budget, ctypes.byref(g1), ctypes.byref(g2),
    )
    if not ok:
        return None
    return int(g1.value), int(g2.value)


def overlap_check_1d(fft_size, batch, stride, distance) -> int:
    """Colliding batch index or -1."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native planner unavailable")
    return int(lib.pf_overlap_check_1d(fft_size, batch, stride, distance))
