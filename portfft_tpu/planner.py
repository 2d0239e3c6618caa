"""Transform planner: factorization and implementation-level selection.

Analogue of the reference commit engine's ``prepare_implementation``
(committed_descriptor_impl.hpp:211-313) and the factorization helpers
(common/workitem.hpp:136-144 ``factorize``, common/subgroup.hpp:227-238
``factorize_sg``, utils.hpp:94-132 ``factorize_input``).  Where the
reference sizes levels by registers / subgroup width / local memory / LLC,
this planner sizes them by the knobs of :class:`~.config.DeviceConfig`:
the largest matmul factor, the DIRECT threshold and working-set budgets.

A 1D size decomposes into a chain of factors, each ≤ ``max_factor`` (128):
every factor pass is one complex matmul against that factor's DFT matrix —
primality of a factor is irrelevant, unlike the reference's register-based
naive-DFT fallback.  Level selection:

* DIRECT    — n ≤ ``direct_threshold``: the whole transform is one DFT
              matmul.
* FUSED     — the factor chain's working set fits ``fused_budget_bytes``:
              one Stockham chain of matmul stages.
* GLOBAL    — n = G1·G2 four-step decomposition with DIRECT/FUSED
              sub-transforms and transposes between them (reference
              global engine, global_dispatcher.hpp:312-412).
* BLUESTEIN — n has a prime factor > ``max_factor``: chirp-z via a padded
              convolution (the reference throws for these sizes,
              committed_descriptor_impl.hpp:240-241).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .config import DeviceConfig
from .enums import Level


def prime_factorize(n: int) -> list[int]:
    """Trial-division prime factorization, ascending."""
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return out


def largest_prime_factor(n: int) -> int:
    return prime_factorize(n)[-1] if n > 1 else 1


def factor_chain(n: int, max_factor: int) -> Optional[list[int]]:
    """Split ``n`` into factors each ≤ ``max_factor``, greedily largest-first
    (largest matmul stages; fewest passes).

    Returns None when ``n`` has a prime factor exceeding ``max_factor``
    (→ Bluestein).  Analogue of reference ``factorize_input``
    (utils.hpp:94-132) with the matmul factor bound as the per-pass
    capability bound.  Uses the native C++ core (native/planner.cpp) when
    available.
    """
    try:
        from . import native

        return native.factor_chain(n, max_factor)
    except (RuntimeError, OSError):
        pass
    if n == 1:
        return [1]
    if largest_prime_factor(n) > max_factor:
        return None
    chain = []
    rest = n
    while rest > 1:
        f = 0
        for cand in range(min(rest, max_factor), 1, -1):
            if rest % cand == 0:
                f = cand
                break
        chain.append(f)
        rest //= f
    return chain


def bluestein_conv_n(n: int, single_pass_cap: int = 128 * 256) -> int:
    """Smallest highly-composite convolution length ≥ 2n−1 for the chirp-z
    transform.  The classic choice is the next power of two, but 3·2^k and
    9·2^k sizes also plan to balanced four-step splits and cut convolution
    traffic AND DFT-stage compute — n=65537 needs 131073, where 2^18 =
    262144 overshoots by 2× and 3·2^16 = 196608 plans as 512×384 (896
    cMAC/point), but 9·2^14 = 147456 plans as 384×384: 25% less traffic
    and 14% fewer cMAC/point than 3·2^16.  (The reference has no Bluestein
    at all, committed_descriptor_impl.hpp:240-241.)"""
    need = 2 * n - 1
    best = 1 << need.bit_length()
    # Odd parts 3 and 9 only: their splits (3·2^j or 9·2^j halves with
    # 128 | G2) stay on the planner's two-stage shapes; odd part 5 can
    # strand the planner on splits like 512×320.  9·2^k is only taken in
    # two-pass GLOBAL territory (beyond ``single_pass_cap``, the same
    # 2·max_factor·two_stage_width bound the two-stage gate in
    # :func:`plan_1d` enforces).
    for odd in (3, 9):
        c = odd << max(0, (need // odd).bit_length())
        while c < need:
            c *= 2
        if c % 128 == 0 and c < best and (odd == 3 or c > single_pass_cap):
            best = c
    return best


def stage_shapes(factors: list[int]) -> list[tuple[int, int]]:
    """Per-stage (f, m) pairs of the Cooley–Tukey chain: stage i contracts
    factor ``f_i`` over sub-length ``m_i = prod(factors[i+1:])``."""
    shapes = []
    m = math.prod(factors)
    for f in factors:
        m //= f
        shapes.append((f, m))
    return shapes


@dataclasses.dataclass
class Plan1D:
    """Committed plan for one transform dimension (reference
    ``dimension_struct``, committed_descriptor_impl.hpp:145-163)."""

    n: int
    level: Level
    #: Stockham factor chain (DIRECT/FUSED); empty for GLOBAL/BLUESTEIN.
    factors: list[int]
    #: GLOBAL: the two four-step sub-plans (n = sub[0].n * sub[1].n).
    sub: Optional[tuple["Plan1D", "Plan1D"]] = None
    #: BLUESTEIN: padded convolution length plan (highly composite ≥ 2n-1).
    conv: Optional["Plan1D"] = None

    def describe(self) -> str:
        if self.level == Level.GLOBAL:
            return (
                f"global({self.sub[0].describe()} x {self.sub[1].describe()})"
            )
        if self.level == Level.BLUESTEIN:
            return f"bluestein(n={self.n}, conv={self.conv.describe()})"
        return f"{self.level.value}(n={self.n}, factors={self.factors})"


def fused_working_set_bytes(
    n: int, factors: list[int], rows: int, itemsize: int
) -> int:
    """Working-set estimate of a FUSED chain over ``rows`` batch rows:
    double-buffered input and output planes, two ping-pong planes between
    factor stages, and each factor's DFT matrix and inter-factor twiddles
    once.  The planner compares it with ``fused_budget_bytes``."""
    data = rows * n * itemsize
    in_out = 2 * (2 * data) * 2  # (re+im) in and out, double-buffered
    scratch = 2 * (2 * data)  # ping/pong planes
    tables = sum(2 * f * f * itemsize for f in set(factors))
    tw = sum(2 * f * m * itemsize for f, m in stage_shapes(factors) if m > 1)
    return in_out + scratch + tables + tw


def _fused_capable(n: int, factors, cfg: DeviceConfig, itemsize: int) -> bool:
    if factors is None:
        return False
    return (
        fused_working_set_bytes(n, factors, cfg.fused_rows, itemsize)
        <= cfg.fused_budget_bytes
    )


def two_stage_working_set_bytes(
    a: int, rows: int, width: int, itemsize: int
) -> int:
    """Working-set estimate of the two-stage chain [a, width] over
    ``rows`` batch rows (input/output planes double-buffered, plane
    scratch, stage tensors and their split temporaries)."""
    n = a * width
    ln = rows * width
    return (
        2 * 2 * rows * 2 * n * itemsize    # in/out planes, 2 buffers
        + 2 * rows * a * width * itemsize  # plane scratches
        + 8 * a * ln * itemsize            # stage tensors + split temps
        + 2 * a * ln * itemsize            # interleave scratch
    )


def _two_stage_ok(a: int, cfg: DeviceConfig, itemsize: int) -> bool:
    """True when the two-stage chain [a, w] fits ``fused_budget_bytes`` at
    its smallest row tile w/gcd(a, w).  For a ≥ 64 that tile stays small,
    which keeps n = 256·128 = 32768 on the one-pass FUSED level."""
    w = cfg.two_stage_width
    rows = w // math.gcd(a, w)
    return (
        two_stage_working_set_bytes(a, rows, w, itemsize)
        <= cfg.fused_budget_bytes
    )


def _global_split(n: int, cfg: DeviceConfig, itemsize: int) -> tuple[int, int]:
    """Four-step split n = G1·G2.

    Preference order (analogue of the reference's L2-chunked global
    factorization, committed_descriptor_impl.hpp:271-312):

    1. Both halves DIRECT (≤ direct_threshold, 8-aligned), balanced — both
       passes are single-matmul stages.
    2. G1 = a·w two-stage FUSED (a | 128, w = two_stage_width) with G2
       DIRECT, minimizing the matmul work (a + w + G2) per element, with
       the first pass's working set within ``global_pass_budget_bytes``.
    3. Balanced search over anything plannable (fused × fused, odd
       radices).
    """
    try:
        from . import native

        split = native.global_split(
            n,
            cfg.max_factor,
            cfg.direct_threshold,
            cfg.fused_rows,
            itemsize,
            cfg.fused_budget_bytes,
            cfg.global_pass_budget_bytes,
        )
        if split is not None:
            return split
    except (RuntimeError, OSError):
        pass

    root = int(math.isqrt(n))
    # 1) both-direct balanced
    for g1 in range(root, 1, -1):
        if n % g1:
            continue
        g2 = n // g1
        if (
            g2 <= cfg.direct_threshold
            and g1 <= cfg.direct_threshold
            and g2 % 8 == 0
            and g1 % 8 == 0
        ):
            return g2, g1
    # 2) one-fused: G1 = a·128, G2 direct, cheapest matmul work first
    best = None
    for a in (8, 16, 32, 64, 128):
        g1 = a * 128
        if n % g1:
            continue
        g2 = n // g1
        if not (1 < g2 <= cfg.direct_threshold and g2 % 8 == 0):
            continue
        # first-pass working set at a 64-row tile
        if (
            18 * 64 * g1 * itemsize + 2 * 128 * a * 128 * itemsize
            > cfg.global_pass_budget_bytes
        ):
            continue
        cost = a + 128 + g2
        if best is None or cost < best[0]:
            best = (cost, g1, g2)
    if best is not None:
        return best[1], best[2]
    # 3) balanced search over anything plannable
    fallback = None
    for g1 in range(root, 1, -1):
        if n % g1:
            continue
        g2 = n // g1
        for a, b in ((g2, g1), (g1, g2)):
            ca = factor_chain(a, cfg.max_factor)
            cb = factor_chain(b, cfg.max_factor)
            ok_a = a <= cfg.direct_threshold or _fused_capable(a, ca, cfg, itemsize)
            ok_b = b <= cfg.direct_threshold or _fused_capable(b, cb, cfg, itemsize)
            if ca and cb and ok_a and ok_b:
                return a, b
        if fallback is None:
            fallback = (n // g1, g1)
    if fallback is None:
        # n is prime or near-prime beyond max_factor — caller handles
        # via Bluestein before reaching here.
        raise AssertionError(f"no global split for n={n}")
    return fallback


def plan_1d(n: int, cfg: DeviceConfig, itemsize: int) -> Plan1D:
    """Plan one transform dimension (reference prepare_implementation,
    committed_descriptor_impl.hpp:211-313)."""
    if n <= cfg.direct_threshold:
        # One DFT-matrix matmul — primality is irrelevant.
        return Plan1D(n=n, level=Level.DIRECT, factors=[n])

    chain = factor_chain(n, cfg.max_factor)
    if chain is None:
        # Large prime factor: if n itself is a product with large prime p,
        # peel the smooth part into a four-step with the Bluestein side.
        p = largest_prime_factor(n)
        if p == n:
            return Plan1D(
                n=n,
                level=Level.BLUESTEIN,
                factors=[],
                conv=plan_1d(
                    bluestein_conv_n(
                        n, 2 * cfg.max_factor * cfg.two_stage_width
                    ),
                    cfg,
                    itemsize,
                ),
            )
        return Plan1D(
            n=n,
            level=Level.GLOBAL,
            factors=[],
            sub=(plan_1d(n // p, cfg, itemsize), plan_1d(p, cfg, itemsize)),
        )

    # Prefer the two-stage chain [a, w]: stage A contracts depth a (which
    # may exceed max_factor), so this one-pass form covers n up to
    # 2·max_factor·w = 256·128 = 32768.
    w = cfg.two_stage_width
    a = n // w
    if n % w == 0 and 3 <= a <= 2 * cfg.max_factor and _two_stage_ok(
        a, cfg, itemsize
    ):
        return Plan1D(n=n, level=Level.FUSED, factors=[a, w])

    if _fused_capable(n, chain, cfg, itemsize):
        return Plan1D(n=n, level=Level.FUSED, factors=chain)

    g1, g2 = _global_split(n, cfg, itemsize)
    return Plan1D(
        n=n,
        level=Level.GLOBAL,
        factors=[],
        sub=(plan_1d(g1, cfg, itemsize), plan_1d(g2, cfg, itemsize)),
    )
