"""Twiddle-factor and DFT-matrix precomputation.

Replacement of the reference's twiddle machinery: instead of
constexpr register tables (common/twiddle.hpp, scripts/generate_twiddles.py)
and on-device twiddle-precompute kernels (subgroup_dispatcher.hpp:666-693,
workgroup_dispatcher.hpp:382-443, global_dispatcher.hpp:109-256), all factor
DFT matrices and inter-factor twiddles are computed on the host **in float64**
(as the reference's global path does, global_dispatcher.hpp:153-161), cast to
the compute precision, and shipped to the device once at commit time.

The executor's unit of compute is a matmul, so the "twiddle table" of a
factor f is the full f×f DFT matrix, stored as a separate real and imaginary
plane: a radix-f butterfly pass over M sub-transforms becomes a
(batch·M, f)·(f, f) complex matmul = 4 real matmuls.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)  # bounded: distributed-scale tables can
# reach n elements each; an unbounded cache would pin GBs of f64 planes in
# host memory for the process lifetime
def _dft_matrix_f64(n: int, sign: int) -> tuple:
    """n×n DFT matrix W[j, k] = exp(sign · 2πi · j·k / n) in float64.

    ``sign=-1`` is the forward transform, ``+1`` backward (the reference gets
    the backward direction by conjugating around the forward kernel,
    committed_descriptor_impl.hpp:467-474; here the conjugation is baked into
    the table).
    """
    j = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    # Use the exact residue to keep large-n arguments small: precision of the
    # twiddle argument limits accuracy at N=2^20 (SURVEY.md §7 hard part 5).
    jk = np.mod(j * k, n)
    theta = (2.0 * np.pi / n) * jk
    return np.cos(theta), np.array(sign, np.float64) * np.sin(theta)


def dft_matrix(n: int, sign: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag planes of the n-point DFT matrix in ``dtype``."""
    re, im = _dft_matrix_f64(n, sign)
    return re.astype(dtype), im.astype(dtype)


@functools.lru_cache(maxsize=64)
def _twiddles_f64(f: int, m: int, sign: int) -> tuple:
    """Inter-factor twiddles T[j, t] = exp(sign·2πi·j·t/(f·m)), shape (f, m).

    These sit between the radix-f pass and the length-m sub-transforms in the
    Cooley–Tukey split N = f·m (the reference applies them as the
    ``multiply_on_store`` modifier between global-level factors,
    committed_descriptor_impl.hpp:467-468).
    """
    n = f * m
    j = np.arange(f, dtype=np.float64)[:, None]
    t = np.arange(m, dtype=np.float64)[None, :]
    jt = np.mod(j * t, n)
    theta = (2.0 * np.pi / n) * jt
    return np.cos(theta), np.array(sign, np.float64) * np.sin(theta)


def twiddles(f: int, m: int, sign: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag planes of the (f, m) inter-factor twiddle array."""
    re, im = _twiddles_f64(f, m, sign)
    return re.astype(dtype), im.astype(dtype)


def bluestein_chirp(n: int, sign: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Chirp sequence c[k] = exp(sign·πi·k²/n) for the Bluestein algorithm.

    Shape (n,), float64-computed.  k² mod 2n keeps the argument small.
    """
    k = np.arange(n, dtype=np.float64)
    ksq = np.mod(k * k, 2.0 * n)
    theta = (np.pi / n) * ksq
    return (
        np.cos(theta).astype(dtype),
        (np.array(sign, np.float64) * np.sin(theta)).astype(dtype),
    )
