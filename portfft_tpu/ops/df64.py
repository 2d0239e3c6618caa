"""Double-double (df64) FFT executor: emulated fp64 from float32 math.

For devices without native float64 (the reference gates fp64 on the device
aspect and skips, fft_test_utils.hpp:441-448): an opt-in emulated path
representing every real as an unevaluated sum of two float32s (hi + lo),
giving ~2^-48 effective precision — documented as extended precision, not
IEEE binary64 (whose eps is 2^-52).  A device with native fp64 runs
``precision="float64"`` natively under ``jax_enable_x64`` instead.

Matmuls are useless here: a matmul accumulates in f32, so a long dot loses
~2^-24·√N — the df64 executor instead runs the Cooley–Tukey chain with
SMALL radices where every butterfly is elementwise arithmetic built on
error-free transformations (TwoSum / Dekker TwoProd).  Correctness-
oriented: throughput is far below the f32 path and scales with the number
of stages.

Enable with ``Descriptor(..., precision="float64")`` committed with
``emulate_fp64=True`` (or env PORTFFT_EMULATE_FP64=1).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

_SPLIT = np.float32(4097.0)  # Dekker split constant for f32: 2^12 + 1


# ---------------------------------------------------------------------------
# Error-free transformations on f32 (classic Dekker/Knuth algorithms)
# ---------------------------------------------------------------------------


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Requires |a| >= |b| (holds after normalization)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ---------------------------------------------------------------------------
# df64 scalar ops on (hi, lo) pairs
# ---------------------------------------------------------------------------


def add(ah, al, bh, bl):
    sh, se = _two_sum(ah, bh)
    te = al + bl
    return _quick_two_sum(sh, se + te)


def sub(ah, al, bh, bl):
    return add(ah, al, -bh, -bl)


def mul(ah, al, bh, bl):
    ph, pe = _two_prod(ah, bh)
    pe = pe + (ah * bl + al * bh)
    return _quick_two_sum(ph, pe)


def cmul(ar, ai, br, bi):
    """Complex df64 multiply; each operand is ((hi, lo), (hi, lo))."""
    t1 = mul(*ar, *br)
    t2 = mul(*ai, *bi)
    t3 = mul(*ar, *bi)
    t4 = mul(*ai, *br)
    return (sub(*t1, *t2), add(*t3, *t4))


def cadd(ar, ai, br, bi):
    return (add(*ar, *br), add(*ai, *bi))


def csub(ar, ai, br, bi):
    return (sub(*ar, *br), sub(*ai, *bi))


# ---------------------------------------------------------------------------
# Host-side conversion + twiddle tables (exact hi/lo splits of f64 values)
# ---------------------------------------------------------------------------


def split_f64(x: np.ndarray):
    """f64 array -> exact (hi, lo) f32 pair arrays."""
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def join_f64(hi, lo) -> np.ndarray:
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


@functools.lru_cache(maxsize=None)
def _factorize(n: int):
    """Radix chain for the butterfly executor: preferred small radices
    (radix 8 minimizes the ~60 elementwise df64 ops per element per
    stage), then any remaining prime ≤ 128 as a naive per-row DFT stage
    (the reference's naive_dft fallback for primes, workitem.hpp:65-89).
    None when a prime factor exceeds 128 (→ caller raises; Bluestein in
    df64 would need a df64 convolution engine)."""
    out = []
    rest = n
    for f in (8, 9, 13, 11, 7, 5, 4, 3, 2):
        while rest % f == 0:
            out.append(f)
            rest //= f
    if rest > 1:
        d = 3
        while d * d <= rest:
            while rest % d == 0:
                if d > 128:
                    return None
                out.append(d)
                rest //= d
            d += 2
        if rest > 1:
            if rest > 128:
                return None
            out.append(rest)
    return out


def df64_tables(n: int, sign: int):
    """Per-stage twiddle tables (hi/lo f32, f64-exact) for the chain of n,
    plus per-factor DFT coefficient tables.  Returns a flat dict of numpy
    arrays keyed by stable names (shipped to device as bank entries)."""
    chain = _factorize(n)
    assert chain is not None
    tabs: dict[str, np.ndarray] = {}
    m = n
    for idx, f in enumerate(chain):
        m //= f
        # inter-factor twiddles W_{f·m}^{k1·n2}, shape (f, m)
        j = np.arange(f, dtype=np.float64)[:, None]
        t = np.arange(m, dtype=np.float64)[None, :]
        theta = (2.0 * np.pi / (f * m)) * np.mod(j * t, f * m)
        for name, v in (
            ("twr", np.cos(theta)),
            ("twi", sign * np.sin(theta)),
        ):
            hi, lo = split_f64(v)
            tabs[f"s{idx}_{name}h"] = hi
            tabs[f"s{idx}_{name}l"] = lo
        if f"f{f}_wrh" not in tabs:
            k = np.arange(f, dtype=np.float64)
            th = (2.0 * np.pi / f) * np.mod(k[:, None] * k[None, :], f)
            for name, v in (("wr", np.cos(th)), ("wi", sign * np.sin(th))):
                hi, lo = split_f64(v)
                tabs[f"f{f}_{name}h"] = hi
                tabs[f"f{f}_{name}l"] = lo
    return chain, tabs


# ---------------------------------------------------------------------------
# Executor: recursive Cooley–Tukey with elementwise df64 butterflies
# ---------------------------------------------------------------------------


def _dft_factor(x, f: int, bank, prefix: str):
    """Naive f-point DFT along axis -2 of ((rh, rl), (ih, il)) with shape
    (..., f, m).  Vectorized over the output index k: one df64
    multiply-accumulate per input row j.

    The j loop unrolls for small radices (full ~2^-48 df64 precision).
    Naive-prime stages (13 < f ≤ 128) run as ``fori_loop``: the unrolled
    f·60-op graph compiles pathologically slowly on XLA:CPU (minutes at
    f=31 under multi-device configs), and its while-loop codegen perturbs
    the error-free transformations — measured ~2·10⁻⁸ relative instead of
    ~5·10⁻¹⁵ on the CPU (still well beyond fp32, but short of full
    df64)."""
    import jax

    (rh, rl), (ih, il) = x
    wrh = bank[prefix + "wrh"]
    wrl = bank[prefix + "wrl"]
    wih = bank[prefix + "wih"]
    wil = bank[prefix + "wil"]

    def step(j, acc):
        def row(a):
            return jax.lax.dynamic_slice_in_dim(a, j, 1, axis=a.ndim - 2)

        xr = (row(rh), row(rl))  # (..., 1, m)
        xi = (row(ih), row(il))

        def wcol(w):
            return jax.lax.dynamic_slice_in_dim(w, j, 1, axis=0)[0][:, None]

        w_r = (wcol(wrh), wcol(wrl))  # (f, 1) -> k on axis -2
        w_i = (wcol(wih), wcol(wil))
        pr, pi = cmul(xr, xi, w_r, w_i)  # broadcast -> (..., f, m)
        if acc is None:
            return pr, pi
        acc_r, acc_i = acc
        return add(*acc_r, *pr), add(*acc_i, *pi)

    if f <= 13:
        acc = None
        for j in range(f):
            acc = step(j, acc)
        return acc
    shape = rh.shape
    zero = jnp.zeros(shape, rh.dtype)
    init = ((zero, zero), (zero, zero))
    return jax.lax.fori_loop(0, f, step, init)


def exec_chain(x, chain, bank, stage: int = 0):
    """x = ((rh, rl), (ih, il)) with last axis length prod(chain); returns
    the transformed planes (natural order)."""
    (rh, rl), (ih, il) = x
    n = rh.shape[-1]
    if not chain:
        return x
    f = chain[0]
    m = n // f
    lead = rh.shape[:-1]

    def v(a):
        return a.reshape(*lead, f, m)

    y = _dft_factor(((v(rh), v(rl)), (v(ih), v(il))), f, bank, f"f{f}_")
    if m > 1:
        twr = (bank[f"s{stage}_twrh"], bank[f"s{stage}_twrl"])
        twi = (bank[f"s{stage}_twih"], bank[f"s{stage}_twil"])
        (yrh, yrl), (yih, yil) = y
        r2, i2 = cmul((yrh, yrl), (yih, yil), twr, twi)
        y = (r2, i2)
        # recurse over the m axis: [k1, n2] -> [k1, n2] transformed
        (yrh, yrl), (yih, yil) = y
        sub_in = ((yrh, yrl), (yih, yil))
        sub_out = exec_chain(sub_in, chain[1:], bank, stage + 1)
        (crh, crl), (cih, cil) = sub_out
        # X[k1 + f·k2] = C[k1, k2]: interleave factor-major
        def fl(a):
            return jnp.swapaxes(a, -2, -1).reshape(*lead, n)

        return (fl(crh), fl(crl)), (fl(cih), fl(cil))
    return (
        (y[0][0].reshape(*lead, n), y[0][1].reshape(*lead, n)),
        (y[1][0].reshape(*lead, n), y[1][1].reshape(*lead, n)),
    )


def supported(n: int) -> bool:
    return _factorize(n) is not None
