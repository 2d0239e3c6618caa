"""fp64 feature-matrix sweep.

The reference instantiates its ENTIRE FFT test suite in double precision
(reference test/unit_test/fft_double.cpp, the per-precision instantiation
macros of instantiate_fft_tests.hpp:375-403).  This file runs the feature
matrix (offsets, strided layouts, batch-interleaved, split-complex
storage, in-place placement, scales, REAL domain, multi-dim) under
np.float64 with ``jax_enable_x64`` (tests/conftest.py); the double-double
emulation has its own suite (test_df64.py).
"""

import numpy as np
import pytest

from portfft_tpu import ComplexStorage, Descriptor, Domain, Placement
from portfft_tpu.enums import Direction

from fft_test_utils import run_test

F, B = Direction.FORWARD, Direction.BACKWARD


@pytest.mark.parametrize("n", [16, 1024, 4096])
@pytest.mark.parametrize("direction", [F, B])
def test_fp64_offsets(n, direction):
    run_test(
        direction=direction,
        lengths=[n],
        number_of_transforms=4,
        forward_offset=5,
        backward_offset=11,
        precision=np.float64,
    )


@pytest.mark.parametrize("n,stride,gap", [(64, 2, 0), (1024, 3, 7)])
def test_fp64_strided_input(n, stride, gap):
    run_test(
        lengths=[n],
        number_of_transforms=6,
        forward_strides=[stride],
        forward_distance=(n - 1) * stride + 1 + gap,
        backward_strides=[1],
        backward_distance=n,
        precision=np.float64,
    )


@pytest.mark.parametrize("n", [64, 1024])
def test_fp64_strided_output(n):
    run_test(
        lengths=[n],
        number_of_transforms=3,
        forward_strides=[1],
        forward_distance=n,
        backward_strides=[2],
        backward_distance=2 * n,
        precision=np.float64,
    )


@pytest.mark.parametrize("n", [16, 512])
@pytest.mark.parametrize("direction", [F, B])
def test_fp64_batch_interleaved(n, direction):
    b = 5
    run_test(
        direction=direction,
        lengths=[n],
        number_of_transforms=b,
        forward_strides=[b],
        forward_distance=1,
        backward_strides=[b],
        backward_distance=1,
        precision=np.float64,
    )


@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("direction", [F, B])
def test_fp64_split_complex(n, direction):
    run_test(
        direction=direction,
        lengths=[n],
        number_of_transforms=3,
        complex_storage=ComplexStorage.SPLIT_COMPLEX,
        precision=np.float64,
    )


@pytest.mark.parametrize("n", [128, 2048])
def test_fp64_in_place(n):
    run_test(
        lengths=[n],
        number_of_transforms=2,
        placement=Placement.IN_PLACE,
        precision=np.float64,
    )


@pytest.mark.parametrize("direction", [F, B])
def test_fp64_scale(direction):
    run_test(
        direction=direction,
        lengths=[1024],
        number_of_transforms=2,
        forward_scale=0.125,
        backward_scale=3.0,
        precision=np.float64,
    )


@pytest.mark.parametrize("n", [32, 1024])
def test_fp64_real_domain(n):
    # run_test's oracle materializes complex input; REAL forward takes a
    # real buffer — drive it directly (pattern of test_real_domain.py)
    b = 3
    desc = Descriptor(
        lengths=[n], number_of_transforms=b,
        domain=Domain.REAL, precision=np.float64,
    )
    plan = desc.commit()
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (b, n)).astype(np.float64)
    y = np.asarray(plan.compute_forward(x.reshape(-1)))
    ref = np.fft.rfft(x, axis=-1)
    got = y.reshape(b, n // 2 + 1)
    assert np.allclose(got, ref, atol=1e-10), np.abs(got - ref).max()


def test_fp64_real_backward():
    n, b = 256, 2
    desc = Descriptor(
        lengths=[n], number_of_transforms=b,
        domain=Domain.REAL, precision=np.float64,
    )
    plan = desc.commit()
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (b, n)).astype(np.float64)
    spec = np.fft.rfft(x, axis=-1)
    y = np.asarray(plan.compute_backward(spec.reshape(-1)))
    assert np.allclose(y.reshape(b, n) / n, x, atol=1e-10)


@pytest.mark.parametrize("lengths", [[16, 64], [8, 16, 32]])
def test_fp64_multidim_features(lengths):
    run_test(
        lengths=lengths,
        number_of_transforms=2,
        forward_offset=3,
        precision=np.float64,
    )


def test_fp64_split_in_place():
    run_test(
        lengths=[512],
        number_of_transforms=2,
        complex_storage=ComplexStorage.SPLIT_COMPLEX,
        placement=Placement.IN_PLACE,
        precision=np.float64,
    )


def test_fp64_tolerance_is_double():
    """fp64 results must actually be double-accurate (~1e-12), not fp32
    results widened — guards the executor against silently downcasting.
    Oracle tolerance would pass a 1e-6 error; this asserts 1e-10."""
    n, b = 4096, 2
    desc = Descriptor(
        lengths=[n], number_of_transforms=b, precision=np.float64
    )
    plan = desc.commit()
    rng = np.random.default_rng(9)
    x = (
        rng.uniform(-1, 1, (b, n)) + 1j * rng.uniform(-1, 1, (b, n))
    ).astype(np.complex128)
    got = np.asarray(plan.compute_forward(x.reshape(-1)))
    got = got.view(np.complex128).reshape(b, n)
    ref = np.fft.fft(x)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 1e-10, rel
