"""Native C++ planner core: availability and parity with the pure-Python
implementations."""

import pytest

from portfft_tpu import native
from portfft_tpu.config import DeviceConfig


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def _py_factor_chain(n, max_factor):
    # pure-python reference (the planner's fallback body)
    from portfft_tpu.planner import largest_prime_factor

    if n == 1:
        return [1]
    if largest_prime_factor(n) > max_factor:
        return None
    chain, rest = [], n
    while rest > 1:
        f = next(
            cand
            for cand in range(min(rest, max_factor), 1, -1)
            if rest % cand == 0
        )
        chain.append(f)
        rest //= f
    return chain


def test_factor_chain_parity(lib):
    for n in [1, 2, 6, 96, 128, 363, 4096, 6000, 12288, 65536, 1 << 20, 65537]:
        assert native.factor_chain(n, 128) == _py_factor_chain(n, 128)


def test_prime_factorize(lib):
    import ctypes

    buf = (ctypes.c_int64 * 64)()
    cnt = lib.pf_prime_factorize(360, buf, 64)
    assert [buf[i] for i in range(cnt)] == [2, 2, 2, 3, 3, 5]
    assert lib.pf_largest_prime_factor(65537) == 65537


def test_overlap_check_parity(lib):
    cases = [
        (8, 4, 4, 8, True),   # colliding
        (8, 4, 1, 8, False),  # packed
        (8, 16, 16, 1, False),  # batch interleaved
        (16, 4, 3, 48, False),  # strided, separated
        (16, 3, 2, 16, True),  # stride 2 distance 16 < 32 footprint
    ]
    for fft, batch, stride, dist, collides in cases:
        got = native.overlap_check_1d(fft, batch, stride, dist)
        assert (got >= 0) == collides, (fft, batch, stride, dist, got)


def test_global_split_matches_python(lib):
    from portfft_tpu.planner import _global_split

    cfg = DeviceConfig()
    for n in [1 << 17, 1 << 20, 9800 * 16]:
        nat = native.global_split(
            n, cfg.max_factor, cfg.direct_threshold, cfg.fused_rows, 4,
            cfg.fused_budget_bytes, cfg.global_pass_budget_bytes,
        )
        py = _global_split(n, cfg, 4)
        assert nat == py, (n, nat, py)


def test_planner_uses_native_transparently(lib):
    # end-to-end: plans still correct with native core active
    from portfft_tpu.planner import plan_1d

    plan = plan_1d(1 << 20, DeviceConfig(), 4)
    assert plan.level.value == "global"
    g1, g2 = plan.sub
    assert g1.n * g2.n == 1 << 20
