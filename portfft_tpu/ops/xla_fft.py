"""Plan executor: batched mixed-radix FFT as matrix contractions.

This is the compute core of the framework — the replacement for the
reference's four device-kernel families (wi_dft workitem.hpp:201, sg_dft
subgroup.hpp:272, wg_dft workgroup.hpp:320, and the global engine
common/global.hpp).  The load-bearing translation: a radix-f butterfly pass
over a batch of sub-transforms is a (rows, f) × (f, f) complex matmul against
the factor's DFT matrix, executed as four real matmuls; the cross-lane
shuffles of the reference become transposes that XLA schedules between the
matmuls.

Complex data is carried as separate (re, im) float planes throughout.  Every
function here is shape-static and jit-traceable.

The Cooley–Tukey split used at every level, for n = f·m, with x viewed as
x[n1, n2] (n = n1·m + n2):

    A[n2, k1] = sum_{n1} x[n1, n2] · W_f[n1, k1]        (factor DFT)
    B[n2, k1] = A[n2, k1] · W_n^{k1·n2}                  (inter-factor twiddle)
    C[k1, k2] = DFT_m over n2 of B[·, k1]                (recursion)
    X[k1 + f·k2] = C[k1, k2]                             (digit reversal)

DIRECT/FUSED leaves run the chain with single-matmul stages; GLOBAL nodes run
the same split with recursive sub-plans (reference global_dispatcher.hpp);
BLUESTEIN converts a large-prime size into a padded convolution.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import twiddle as tw
from ..enums import Level
from ..planner import Plan1D

Array = jax.Array

#: Precision of the factor matmuls.  HIGHEST (the default) keeps full
#: float32 accuracy; on an H100, "default" and "high" run float32 matmuls
#: in TF32, which fails the oracle's tolerance (chip_smoke.py's precision
#: phase measures this).  Settable per commit
#: (CommittedDescriptor(..., matmul_precision=...)).
_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}
_PRECISION = jax.lax.Precision.HIGHEST


def resolve_precision(p):
    if p is None:
        return _PRECISION
    if isinstance(p, str):
        return _PRECISIONS[p.lower()]
    return p


# ---------------------------------------------------------------------------
# Twiddle bank: all constant device arrays a plan needs, built at commit time.
# ---------------------------------------------------------------------------


class TwiddleBank:
    """Named constant arrays for a committed plan (the analogue of the
    reference's twiddle USM allocations, committed_descriptor_impl.hpp:737-752).

    Keys are stable strings so the executor can be traced with the bank as a
    pytree argument — twiddles are real runtime inputs, not baked constants.
    """

    def __init__(self, dtype: np.dtype):
        self.dtype = np.dtype(dtype)
        self.host: dict[str, np.ndarray] = {}

    def dft(self, f: int, sign: int) -> str:
        key = f"W{'f' if sign < 0 else 'b'}{f}"
        if key not in self.host:
            re, im = tw.dft_matrix(f, sign, self.dtype)
            self.host[key + "r"] = re
            self.host[key + "i"] = im
            self.host[key] = None  # marker
        return key

    def twiddle(self, f: int, m: int, sign: int) -> str:
        key = f"T{'f' if sign < 0 else 'b'}{f}x{m}"
        if key not in self.host:
            re, im = tw.twiddles(f, m, sign, self.dtype)
            # Stored transposed (m, f): the executor's data layout has the
            # sub-transform index n2 on the rows and k1 on the columns.
            self.host[key + "r"] = np.ascontiguousarray(re.T)
            self.host[key + "i"] = np.ascontiguousarray(im.T)
            self.host[key] = None
        return key

    def chirp(self, n: int, conv_n: int, sign: int) -> str:
        """Bluestein chirp c and b̂ = DFT of the zero-padded mirrored
        conjugate chirp.  The backward convolution's 1/conv_n normalization
        is folded into the b̂ table (one fewer elementwise pass at execute
        time)."""
        key = f"B{'f' if sign < 0 else 'b'}{n}_{conv_n}"
        if key not in self.host:
            cr, ci = tw.bluestein_chirp(n, sign, np.float64)
            c = cr + 1j * ci
            b = np.zeros(conv_n, dtype=np.complex128)
            b[:n] = np.conj(c)
            b[conv_n - n + 1 :] = np.conj(c)[1:][::-1]
            bf = np.fft.fft(b) * (1.0 / conv_n)
            self.host[key + "cr"] = c.real.astype(self.dtype)
            self.host[key + "ci"] = c.imag.astype(self.dtype)
            self.host[key + "br"] = bf.real.astype(self.dtype)
            self.host[key + "bi"] = bf.imag.astype(self.dtype)
            self.host[key] = None
        return key

    def rfft_untangle(self, n: int, sign: int) -> str:
        """Post-twiddle W^k = exp(sign·2πi·k/n), k < n/2, for the packed
        half-length real transform (forward untangle / backward retangle)."""
        key = f"R{'f' if sign < 0 else 'b'}{n}"
        if key not in self.host:
            h = n // 2
            k = np.arange(h, dtype=np.float64)
            theta = (2.0 * np.pi / n) * k
            self.host[key + "r"] = np.cos(theta).astype(self.dtype)
            self.host[key + "i"] = (
                np.float64(sign) * np.sin(theta)
            ).astype(self.dtype)
            self.host[key] = None
        return key

    def device_arrays(self, device=None) -> dict[str, Array]:
        """Ship the bank to the device.  ``device`` (a ``jax.Device`` or a
        ``jax.sharding.Sharding``) places the arrays explicitly —
        ``commit(device=jax.devices()[1])`` keeps the twiddle tables
        co-resident with the computation in multi-device processes (the
        analogue of the reference allocating twiddle USM on the commit
        queue's device, committed_descriptor_impl.hpp:737-752), and a
        replicated ``NamedSharding`` puts one copy on every device of a
        mesh.  Anything else (None, a DeviceConfig) uses the default
        device."""
        host = {k: v for k, v in self.host.items() if v is not None}
        if isinstance(device, (jax.Device, jax.sharding.Sharding)):
            return jax.device_put(host, device)
        return {k: jnp.asarray(v) for k, v in host.items()}


# ---------------------------------------------------------------------------
# Complex building blocks
# ---------------------------------------------------------------------------


def complex_matmul_last(
    xr: Array, xi: Array, wr: Array, wi: Array, precision=None
) -> tuple[Array, Array]:
    """(..., f) @ (f, k) complex matmul as four real matmuls."""
    precision = resolve_precision(precision)
    rr = jnp.matmul(xr, wr, precision=precision)
    ii = jnp.matmul(xi, wi, precision=precision)
    ri = jnp.matmul(xr, wi, precision=precision)
    ir = jnp.matmul(xi, wr, precision=precision)
    return rr - ii, ri + ir


def complex_mul(
    ar: Array, ai: Array, br: Array, bi: Array
) -> tuple[Array, Array]:
    return ar * br - ai * bi, ar * bi + ai * br


# ---------------------------------------------------------------------------
# Chain (leaf) executor — DIRECT / FUSED levels in pure XLA
# ---------------------------------------------------------------------------


def exec_chain_xla(
    xr: Array,
    xi: Array,
    factors: list[int],
    sign: int,
    bank_keys: dict,
    bank: dict[str, Array],
    precision=None,
) -> tuple[Array, Array]:
    """Run a Stockham factor chain over the last axis (length prod(factors)).

    Reference analogue: wi_dft's recursive Cooley–Tukey
    (common/workitem.hpp:106-127) with each butterfly pass widened to a
    matmul.
    """
    n = math.prod(factors)
    if len(factors) == 1:
        wkey = bank_keys[("W", factors[0], sign)]
        return complex_matmul_last(
            xr, xi, bank[wkey + "r"], bank[wkey + "i"], precision
        )

    f, rest = factors[0], factors[1:]
    m = n // f
    lead = xr.shape[:-1]
    # [n1, n2] -> [n2, n1]
    xr = xr.reshape(*lead, f, m).swapaxes(-2, -1)
    xi = xi.reshape(*lead, f, m).swapaxes(-2, -1)
    # factor DFT over n1
    wkey = bank_keys[("W", f, sign)]
    ar, ai = complex_matmul_last(
        xr, xi, bank[wkey + "r"], bank[wkey + "i"], precision
    )
    # inter-factor twiddle, stored (m, f) = [n2, k1]
    tkey = bank_keys[("T", f, m, sign)]
    ar, ai = complex_mul(ar, ai, bank[tkey + "r"], bank[tkey + "i"])
    # recurse over the m axis: [n2, k1] -> [k1, n2]
    ar = ar.swapaxes(-2, -1)
    ai = ai.swapaxes(-2, -1)
    cr, ci = exec_chain_xla(ar, ai, rest, sign, bank_keys, bank, precision)
    # X[k1 + f*k2] = C[k1, k2] -> flatten k2-major
    cr = cr.swapaxes(-2, -1).reshape(*lead, n)
    ci = ci.swapaxes(-2, -1).reshape(*lead, n)
    return cr, ci


# ---------------------------------------------------------------------------
# Plan tree executor
# ---------------------------------------------------------------------------


def collect_bank_keys(
    plan: Plan1D, sign: int, bank: TwiddleBank, keys: Optional[dict] = None
) -> dict:
    """Walk the plan tree, materializing every constant the executor will
    need and returning the key map used during tracing."""
    if keys is None:
        keys = {}
    if plan.level in (Level.DIRECT, Level.FUSED):
        for f, m in _stage_shapes(plan.factors):
            keys[("W", f, sign)] = bank.dft(f, sign)
            if m > 1:
                keys[("T", f, m, sign)] = bank.twiddle(f, m, sign)
    elif plan.level == Level.GLOBAL:
        g1, g2 = plan.sub
        keys[("T", g1.n, g2.n, sign)] = bank.twiddle(g1.n, g2.n, sign)
        collect_bank_keys(g1, sign, bank, keys)
        collect_bank_keys(g2, sign, bank, keys)
    elif plan.level == Level.BLUESTEIN:
        keys[("B", plan.n, sign)] = bank.chirp(plan.n, plan.conv.n, sign)
        collect_bank_keys(plan.conv, -1, bank, keys)
        collect_bank_keys(plan.conv, +1, bank, keys)
    return keys


def _stage_shapes(factors: list[int]):
    from ..planner import stage_shapes

    return stage_shapes(factors)


def exec_plan(
    xr: Array,
    xi: Array,
    plan: Plan1D,
    sign: int,
    bank_keys: dict,
    bank: dict[str, Array],
    precision=None,
) -> tuple[Array, Array]:
    """Execute a plan tree over the last axis of (xr, xi)."""
    if plan.level in (Level.DIRECT, Level.FUSED):
        return exec_chain_xla(
            xr, xi, plan.factors, sign, bank_keys, bank, precision
        )

    if plan.level == Level.GLOBAL:
        g1, g2 = plan.sub
        f, m = g1.n, g2.n
        lead = xr.shape[:-1]
        xr = xr.reshape(*lead, f, m).swapaxes(-2, -1)
        xi = xi.reshape(*lead, f, m).swapaxes(-2, -1)
        ar, ai = exec_plan(xr, xi, g1, sign, bank_keys, bank, precision)
        tkey = bank_keys[("T", f, m, sign)]
        ar, ai = complex_mul(ar, ai, bank[tkey + "r"], bank[tkey + "i"])
        ar = ar.swapaxes(-2, -1)
        ai = ai.swapaxes(-2, -1)
        cr, ci = exec_plan(ar, ai, g2, sign, bank_keys, bank, precision)
        cr = cr.swapaxes(-2, -1).reshape(*lead, plan.n)
        ci = ci.swapaxes(-2, -1).reshape(*lead, plan.n)
        return cr, ci

    if plan.level == Level.BLUESTEIN:
        return _exec_bluestein(xr, xi, plan, sign, bank_keys, bank, precision)

    raise AssertionError(f"unknown level {plan.level}")


def _exec_bluestein(
    xr, xi, plan: Plan1D, sign, bank_keys, bank, precision=None
) -> tuple[Array, Array]:
    """Chirp-z transform: X[k] = c[k] · IDFT_M(DFT_M(x·c) · DFT_M(b))[k]
    with c[j] = exp(sign·πi·j²/n).  Capability beyond the reference, which
    throws for prime sizes > its subgroup envelope
    (committed_descriptor_impl.hpp:240-241)."""
    n, conv_n = plan.n, plan.conv.n
    bkey = bank_keys[("B", n, sign)]
    cr, ci = bank[bkey + "cr"], bank[bkey + "ci"]
    ar, ai = complex_mul(xr, xi, cr, ci)
    pad = [(0, 0)] * (ar.ndim - 1) + [(0, conv_n - n)]
    ar = jnp.pad(ar, pad)
    ai = jnp.pad(ai, pad)
    fr, fi = exec_plan(ar, ai, plan.conv, -1, bank_keys, bank, precision)
    fr, fi = complex_mul(fr, fi, bank[bkey + "br"], bank[bkey + "bi"])
    yr, yi = exec_plan(fr, fi, plan.conv, +1, bank_keys, bank, precision)
    # 1/conv_n is pre-folded into the b table (TwiddleBank.chirp)
    return complex_mul(yr[..., :n], yi[..., :n], cr, ci)
