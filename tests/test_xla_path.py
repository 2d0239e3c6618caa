"""Oracle tests of the plane executor (ops/xla_fft.py) at the shapes the
removed kernel suites covered: DIRECT and FUSED chains with folded scales,
GLOBAL four-step splits, Bluestein primes, REAL sizes, multi-dim shapes,
de/interleave lengths and strided layouts — all on the default path every
device runs."""

import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from fft_test_utils import run_test
from portfft_tpu import Descriptor, Direction, Domain, Level
from portfft_tpu.committed import CommittedDescriptor
from portfft_tpu.config import DeviceConfig
from portfft_tpu.ops import xla_fft
from portfft_tpu.planner import Plan1D, plan_1d

F = Direction.FORWARD
B = Direction.BACKWARD


# --- DIRECT / FUSED chains ---------------------------------------------------


@pytest.mark.parametrize(
    "n,batch,direction,scale",
    [
        (8, 9, F, 1.0),
        (64, 9, F, 1.0),
        (128, 9, F, 1.0),
        (256, 13, F, 1.0),  # batch not a multiple of any tile
        (363, 5, F, 1.0),  # odd radix
        (64, 2, B, 1.0),
        (1024, 16, F, 1.0),  # [8, 128]
        (2048, 8, F, 1.0),  # [16, 128]
        (2048, 2, B, 1.0),
        (4096, 4, F, 1.0),  # [32, 128]
        (4096, 4, B, 1.0 / 4096.0),
        (8192, 4, F, 2.0),  # [64, 128]
        (16384, 4, F, 1.0),  # [128, 128]
        (32768, 2, F, 0.5),  # [256, 128]
    ],
)
def test_chain_levels(n, batch, direction, scale):
    kw = {"forward_scale": scale} if direction == F else {
        "backward_scale": scale
    }
    run_test(direction=direction, lengths=[n], number_of_transforms=batch, **kw)


@pytest.mark.parametrize(
    "n,batch,direction,scale",
    [
        (65536, 2, F, 1.0),  # 256 x 256
        (65536, 1, B, 0.25),
        (131072, 2, F, 1.0),  # 512 x 256
        (262144, 1, F, 1.0),  # 512 x 512
        (524288, 1, F, 1.0),  # fused 2048 x 256
        (1 << 20, 1, B, 1.0),
    ],
)
def test_global_level(n, batch, direction, scale):
    kw = {"forward_scale": scale} if direction == F else {
        "backward_scale": scale
    }
    run_test(direction=direction, lengths=[n], number_of_transforms=batch, **kw)


@pytest.mark.parametrize(
    "g1,g2,sign",
    [
        (256, 256, -1),
        (512, 256, -1),
        (256, 512, +1),
        (128, 256, -1),
        (512, 512, -1),
        (384, 384, -1),  # the 9·2^14 Bluestein convolution split
        (384, 768, +1),
        (256, 1536, -1),  # FUSED second half
        (1536, 384, -1),  # FUSED first half
    ],
)
def test_global_split_shapes(g1, g2, sign):
    """exec_plan on hand-built four-step splits (the shapes the removed
    GLOBAL engines were tuned on) against np.fft."""
    cfg = DeviceConfig()
    n = g1 * g2
    plan = Plan1D(
        n=n,
        level=Level.GLOBAL,
        factors=[],
        sub=(plan_1d(g1, cfg, 4), plan_1d(g2, cfg, 4)),
    )
    bank = xla_fft.TwiddleBank(np.float32)
    keys = xla_fft.collect_bank_keys(plan, sign, bank)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, n)) + 1j * rng.uniform(-1, 1, (2, n))
    xr = jnp.asarray(x.real, jnp.float32)
    xi = jnp.asarray(x.imag, jnp.float32)
    yr, yi = xla_fft.exec_plan(xr, xi, plan, sign, keys, bank.device_arrays())
    got = np.asarray(yr) + 1j * np.asarray(yi)
    ref = np.fft.fft(x, axis=1) if sign < 0 else np.fft.ifft(x, axis=1) * n
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 1e-5, rel


# --- Bluestein -----------------------------------------------------------------


@pytest.mark.parametrize("n", [20011, 65537])
@pytest.mark.parametrize("scale", [1.0, 2.5])
@pytest.mark.parametrize("direction", [F, B])
def test_bluestein_primes_scaled(n, scale, direction):
    kw = {"forward_scale": scale} if direction == F else {
        "backward_scale": scale
    }
    run_test(direction=direction, lengths=[n], number_of_transforms=2, **kw)


# --- REAL ------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,batch",
    [
        (32, 1024),
        (64, 512),
        (256, 128),
        (512, 64),
        (1024, 64),  # first half-length size
        (1040, 8),  # half-length 520: not a power of two
        (2048, 32),
        (4096, 32),
        (8192, 16),
        (16384, 8),
        (32768, 16),
    ],
)
@pytest.mark.parametrize("direction", [F, B])
def test_real_sizes(n, batch, direction):
    plan = Descriptor(
        lengths=[n], number_of_transforms=batch, domain=Domain.REAL
    ).commit()
    rng = np.random.default_rng(n)
    x = rng.uniform(-1, 1, (batch, n)).astype(np.float32)
    spec = np.fft.rfft(x.astype(np.float64), axis=1)
    tol = 2 * np.finfo(np.float32).eps * n * np.log2(n)
    if direction == F:
        got = np.asarray(plan.compute_forward(x.reshape(-1)))
        got = got.reshape(batch, n // 2 + 1)
        ref = spec
    else:
        got = np.asarray(
            plan.compute_backward(spec.astype(np.complex64).reshape(-1))
        ).reshape(batch, n)
        ref = x * n
    diff = np.abs(got - ref)
    assert np.all((diff <= tol) | (diff <= tol * np.abs(ref)))


# --- multi-dim -------------------------------------------------------------------


@pytest.mark.parametrize(
    "lengths,batch",
    [
        ([128, 128], 3),
        ([256, 128], 2),
        ([128, 256], 2),
        ([96, 128], 1),
        ([1024, 128], 1),  # FUSED column axis
        ([128, 1024], 1),
        ([256, 256], 1),
        ([16, 32, 128], 2),
        ([32, 128, 128], 1),
        ([1, 64, 128], 2),  # unit axis
    ],
)
@pytest.mark.parametrize("direction", [F, B])
def test_multidim_shapes(lengths, batch, direction):
    run_test(
        direction=direction,
        lengths=lengths,
        number_of_transforms=batch,
        check_padding=False,
    )


# --- de/interleave ---------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 127, 128, 129, 1000, 128 * 256, 65537])
def test_interleave_round_trip(m):
    rng = np.random.default_rng(m)
    a = rng.uniform(-1, 1, m).astype(np.float32)
    b = rng.uniform(-1, 1, m).astype(np.float32)
    raw = np.asarray(
        CommittedDescriptor._interleave(jnp.asarray(a), jnp.asarray(b))
    )
    assert raw.shape == (2 * m,)
    assert np.array_equal(raw[0::2], a) and np.array_equal(raw[1::2], b)
    ra, rb = CommittedDescriptor._deinterleave(jnp.asarray(raw))
    assert np.array_equal(np.asarray(ra), a)
    assert np.array_equal(np.asarray(rb), b)


@pytest.mark.parametrize("n,batch", [(7, 3), (100, 3), (129, 1), (1000, 5)])
def test_interleaved_counts_not_multiple_of_128(n, batch):
    """Buffers whose scalar count is no multiple of 128, through the numpy
    complex, raw float and jax complex input forms."""
    desc = Descriptor(lengths=[n], number_of_transforms=batch)
    plan = desc.commit()
    x = oracle.gen_input(desc, 3)
    ref = oracle.reference_output(desc, x, F).reshape(-1)
    tol = oracle.tolerance(desc)
    flat = x.reshape(-1)
    outs = [
        np.asarray(plan.compute_forward(flat)),
        np.asarray(plan.compute_forward(flat.view(np.float32))).view(
            np.complex64
        ),
        np.asarray(plan.compute_forward(jnp.asarray(flat))),
    ]
    for got in outs:
        diff = np.abs(got - ref)
        assert np.all((diff <= tol) | (diff <= tol * np.abs(ref)))


# --- strided layouts -------------------------------------------------------------


@pytest.mark.parametrize(
    "n,batch,stride,gap,offset",
    [
        (512, 128, 2, 0, 0),
        (512, 128, 3, 0, 0),
        (1024, 16, 2, 4, 3),
        (256, 8, 4, 0, 1),
    ],
)
def test_strided_input_layouts(n, batch, stride, gap, offset):
    run_test(
        lengths=[n],
        number_of_transforms=batch,
        forward_strides=[stride],
        forward_distance=(n - 1) * stride + 1 + gap,
        backward_strides=[1],
        backward_distance=n,
        forward_offset=offset,
    )


@pytest.mark.parametrize("n,batch,stride", [(512, 128, 2), (256, 16, 3)])
def test_strided_output_layouts(n, batch, stride):
    run_test(
        lengths=[n],
        number_of_transforms=batch,
        forward_strides=[1],
        forward_distance=n,
        backward_strides=[stride],
        backward_distance=stride * n,
    )


# --- matmul precision names --------------------------------------------------


@pytest.mark.parametrize("name", ["highest", "HIGH", "default"])
def test_matmul_precision_names(name):
    desc = Descriptor(lengths=[256], number_of_transforms=4)
    plan = desc.commit(matmul_precision=name)
    rng = np.random.default_rng(0)
    x = (rng.uniform(-1, 1, (4, 256))
         + 1j * rng.uniform(-1, 1, (4, 256))).astype(np.complex64)
    got = np.asarray(plan.compute_forward(x.reshape(-1))).reshape(4, 256)
    # the CPU runs every precision in full float32
    np.testing.assert_allclose(
        got, np.fft.fft(x.astype(np.complex128), axis=1), rtol=0, atol=1e-3
    )


@pytest.mark.parametrize("name", ["x3", "x4", "tf32"])
def test_matmul_precision_unknown_name_raises(name):
    from portfft_tpu.exceptions import InvalidConfiguration

    desc = Descriptor(lengths=[256], number_of_transforms=4)
    with pytest.raises(InvalidConfiguration, match="matmul_precision"):
        desc.commit(matmul_precision=name)
