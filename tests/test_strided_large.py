"""Large-size strided (UNPACKED) layout tests.

The regular-rectangle path (committed.py ``_regular_1d``) handles
stride/distance layouts with reshape + strided slice + masked merge — pure
streaming ops, no index arrays — so strided transforms are exercised here
at GLOBAL-level sizes.  Reference counterpart: the Strided suites of
instantiate_fft_tests.hpp:237-319.
"""

import numpy as np
import pytest

import portfft_tpu as pfft
from portfft_tpu.enums import Direction


def _strided_desc(n, batch, stride, extra_gap=0, offset=0):
    dist = (n - 1) * stride + 1 + extra_gap
    return pfft.Descriptor(
        lengths=[n],
        number_of_transforms=batch,
        forward_strides=[stride],
        forward_distance=dist,
        backward_strides=[1],
        backward_distance=n,
        forward_offset=offset,
        backward_offset=0,
    )


@pytest.mark.parametrize(
    "n,batch,stride,gap,offset",
    [
        (4096, 64, 2, 0, 0),        # FUSED size, dense-packed stride 2
        (4096, 32, 3, 5, 8),        # odd stride + inter-row gap + offset
        (65536, 8, 2, 0, 0),        # GLOBAL size — previously untested
        (65536, 4, 5, 11, 3),       # GLOBAL, irregular-looking but regular
    ],
)
def test_strided_input_large(n, batch, stride, gap, offset):
    desc = _strided_desc(n, batch, stride, gap, offset)
    plan = desc.commit()
    rng = np.random.default_rng(0)
    count = desc.get_input_count(Direction.FORWARD)
    buf = rng.uniform(-1, 1, 2 * count).astype(np.float32)
    x = buf.view(np.complex64)
    # reference: gather rows manually
    dist = desc.forward_distance
    rows = np.stack(
        [
            x[offset + b * dist : offset + b * dist + (n - 1) * stride + 1 : stride]
            for b in range(batch)
        ]
    )
    ref = np.fft.fft(rows)
    got = np.asarray(plan.compute_forward(x)).view(np.complex64)
    got = got.reshape(batch, n)
    tol = 2 * np.finfo(np.float32).eps * n * np.log2(n)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < tol


def test_strided_output_scatter_preserves_gaps():
    """Strided OUTPUT: un-written gap positions must keep their previous
    contents (the oracle's padding-sentinel discipline,
    reference_data_wrangler.hpp:300-317)."""
    n, batch, stride = 1024, 4, 3
    desc = pfft.Descriptor(
        lengths=[n],
        number_of_transforms=batch,
        forward_strides=[1],
        forward_distance=n,
        backward_strides=[stride],
        backward_distance=(n - 1) * stride + 1 + 7,
        placement=pfft.Placement.OUT_OF_PLACE,
    )
    plan = desc.commit()
    rng = np.random.default_rng(1)
    x = (
        rng.uniform(-1, 1, (batch, n)) + 1j * rng.uniform(-1, 1, (batch, n))
    ).astype(np.complex64)
    out_count = desc.get_output_count(Direction.FORWARD)
    sentinel = np.full(out_count, -5.0 - 5.0j, np.complex64)
    got = np.asarray(
        plan.compute_forward(x.reshape(-1), out=sentinel)
    ).view(np.complex64)
    dist = desc.backward_distance
    ref = np.fft.fft(x)
    tol = 2 * np.finfo(np.float32).eps * n * np.log2(n)
    written = np.zeros(out_count, bool)
    for b in range(batch):
        sl = slice(b * dist, b * dist + (n - 1) * stride + 1, stride)
        assert (
            np.linalg.norm(got[sl] - ref[b]) / np.linalg.norm(ref[b]) < tol
        )
        written[sl] = True
    assert np.all(got[~written] == sentinel[~written]), (
        "scatter disturbed unwritten gap positions"
    )


def test_single_transform_ignores_declared_distance():
    """number_of_transforms == 1: the declared distance is meaningless and
    must not size the rectangle (a huge declared distance previously padded
    the gathered block to ``distance`` elements)."""
    n, stride = 1024, 2
    desc = pfft.Descriptor(
        lengths=[n],
        number_of_transforms=1,
        forward_strides=[stride],
        forward_distance=10**9,  # legal: unused for one row
        backward_strides=[1],
        backward_distance=n,
    )
    plan = desc.commit()
    reg = plan._regular_1d(Direction.FORWARD)
    assert reg is not None
    span = (n - 1) * stride + 1
    assert reg[2] == span, "distance must clamp to the span for b == 1"
    # buffer of exactly the required count (offset + span) works
    count = desc.get_input_count(Direction.FORWARD)
    assert count == span
    rng = np.random.default_rng(2)
    buf = rng.uniform(-1, 1, 2 * count).astype(np.float32).view(np.complex64)
    got = np.asarray(plan.compute_forward(buf)).view(np.complex64)
    ref = np.fft.fft(buf[::stride])
    tol = 2 * np.finfo(np.float32).eps * n * np.log2(n)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < tol


def test_no_giant_index_constant_in_jaxpr():
    """The regular strided path must not materialize a (batch, N) index
    array inside the traced function (the round-2 scaling hazard)."""
    import jax

    n, batch, stride = 65536, 512, 2
    desc = _strided_desc(n, batch, stride)
    plan = desc.commit()

    import jax.numpy as jnp

    count = desc.get_input_count(Direction.FORWARD)

    def fn(flat):
        return plan._gather(flat, Direction.FORWARD)

    jaxpr = jax.make_jaxpr(fn)(
        jax.ShapeDtypeStruct((count,), jnp.float32)
    )
    for eqn in jaxpr.eqns:
        assert eqn.primitive.name not in ("gather",), (
            "regular strided layout fell back to the index gather"
        )


def test_irregular_layout_indices_computed_in_trace():
    """Truly irregular layouts (overlapping interleaved reads — the
    reference's arbitrary-interleaved strided suite) must compute their
    index array IN-TRACE from iotas, not bake a (batch, N) constant into
    the executable (round-3 VERDICT missing #3)."""
    import jax
    import jax.numpy as jnp

    n, batch = 65536, 16
    # stride > 1 with distance 1: rows overlap (legal for reads), the
    # rectangle view declines, and the fallback gather engages
    desc = pfft.Descriptor(
        lengths=[n],
        number_of_transforms=batch,
        forward_strides=[batch * 2],
        forward_distance=2,
        backward_strides=[1],
        backward_distance=n,
    )
    plan = desc.commit()
    assert plan._regular_1d(Direction.FORWARD) is None
    count = desc.get_input_count(Direction.FORWARD)

    jaxpr = jax.make_jaxpr(lambda f: plan._gather(f, Direction.FORWARD))(
        jax.ShapeDtypeStruct((count,), jnp.float32)
    )
    # every constant in the traced gather stays tiny — the old path baked
    # a batch*n int32 array (4 MB here, GBs at bench scale)
    for v in jaxpr.consts:
        assert np.asarray(v).nbytes < (1 << 16), (
            f"gather bakes a {np.asarray(v).nbytes}-byte constant"
        )

    # and it still computes the right thing
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, 2 * count).astype(np.float32).view(np.complex64)
    got = np.asarray(plan.compute_forward(x)).view(np.complex64)
    got = got.reshape(batch, n)
    rows = np.stack(
        [x[2 * b : 2 * b + n * 2 * batch : 2 * batch] for b in range(batch)]
    )
    ref = np.fft.fft(rows)
    tol = 2 * np.finfo(np.float32).eps * n * np.log2(n)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < tol


def test_irregular_scatter_indices_in_trace():
    """Irregular OUTPUT layouts scatter through in-trace indices too."""
    import jax
    import jax.numpy as jnp

    n, batch = 512, 8
    desc = pfft.Descriptor(
        lengths=[n],
        number_of_transforms=batch,
        forward_strides=[1],
        forward_distance=n,
        backward_strides=[batch],  # BI-like but with an offset -> UNPACKED
        backward_distance=1,
        backward_offset=3,
    )
    plan = desc.commit()
    out_count = desc.get_output_count(Direction.FORWARD)
    jaxpr = jax.make_jaxpr(
        lambda r, o: plan._scatter(r, o, Direction.BACKWARD)
    )(
        jax.ShapeDtypeStruct((batch, n), jnp.complex64),
        jax.ShapeDtypeStruct((out_count,), jnp.complex64),
    )
    for v in jaxpr.consts:
        assert np.asarray(v).nbytes < (1 << 16)


def test_strided_input_dense_rectangle():
    """A stride-2 input rectangle over 128 rows (the regular-rectangle
    gather) matches the oracle."""
    n, batch, stride = 512, 128, 2
    desc = _strided_desc(n, batch, stride)
    plan = desc.commit()
    rng = np.random.default_rng(4)
    count = desc.get_input_count(Direction.FORWARD)
    buf = rng.uniform(-1, 1, 2 * count).astype(np.float32)
    x = buf.view(np.complex64)
    dist = desc.forward_distance
    rows = np.stack(
        [x[b * dist : b * dist + (n - 1) * stride + 1 : stride]
         for b in range(batch)]
    )
    ref = np.fft.fft(rows)
    got = np.asarray(plan.compute_forward(x)).view(np.complex64)
    got = got.reshape(batch, n)
    tol = 2 * np.finfo(np.float32).eps * n * np.log2(n)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < tol


def test_strided_output_zero_fills_gaps():
    """A strided OUTPUT rectangle: gaps come back zero (library-allocated
    output buffer semantics)."""
    n, batch, stride = 512, 128, 2
    dist = stride * n  # restride needs s*ct | dist
    desc = pfft.Descriptor(
        lengths=[n],
        number_of_transforms=batch,
        forward_strides=[1],
        forward_distance=n,
        backward_strides=[stride],
        backward_distance=dist,
    )
    plan = desc.commit()
    rng = np.random.default_rng(5)
    x = (
        rng.uniform(-1, 1, (batch, n)) + 1j * rng.uniform(-1, 1, (batch, n))
    ).astype(np.complex64)
    got = np.asarray(plan.compute_forward(x.reshape(-1))).view(np.complex64)
    ref = np.fft.fft(x)
    tol = 2 * np.finfo(np.float32).eps * n * np.log2(n)
    out_count = desc.get_output_count(Direction.FORWARD)
    assert got.shape[0] == out_count
    for b in range(0, batch, 37):
        sl = got[b * dist : b * dist + (n - 1) * stride + 1 : stride]
        assert np.linalg.norm(sl - ref[b]) / np.linalg.norm(ref[b]) < tol
    # gap positions are zero-filled
    view = np.zeros(out_count, bool)
    for b in range(batch):
        view[b * dist : b * dist + (n - 1) * stride + 1 : stride] = True
    gaps = got[~view]
    assert gaps.size and np.all(gaps == 0)
