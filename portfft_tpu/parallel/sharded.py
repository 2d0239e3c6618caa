"""Multi-chip execution: batch data-parallelism and a distributed large-N
transform over a device mesh.

Capability beyond the reference (single-device; SURVEY.md §5.8 marks all
distributed parallelism **absent**).  Two strategies:

* :func:`batch_parallel` — embarrassingly parallel batch sharding: each
  device transforms its slice of the batch; zero collectives.  The
  analogue of scaling the reference's batch loop across devices.
* :class:`DistributedFFT` — the transform dimension itself is sharded
  ("sequence parallel" for FFTs): a four-step decomposition n = G1·G2 where
  the inter-factor redistribution is ``all_to_all`` over a mesh axis —
  the distributed generalization of the reference global engine's
  inter-factor transposes (common/global.hpp:192-272).

  forward:  x (B, n) sharded on n →
    all_to_all → local FFT(G1) → twiddle → all_to_all → local FFT(G2)
    [→ all_to_all for natural output order]
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import resolve_device_config
from ..ops import xla_fft
from ..planner import plan_1d


def replicated_bank(bank: dict, mesh: Mesh) -> dict:
    """One copy of every twiddle table on each device of ``mesh``, placed
    once — a bank left on one device would be broadcast from it on every
    call."""
    return jax.device_put(bank, NamedSharding(mesh, P()))


def _per_shard(mesh: Mesh, local, in_specs, out_specs):
    """jit of ``local`` run on each device's own batch slice: chunking
    (``CommittedDescriptor.chunk_rows``) is then decided on the local
    batch, and no step moves data between devices."""
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=out_specs,
            check_vma=False,
        )
    )


def batch_parallel(committed, mesh: Mesh, axis: str = "dp", direction=None):
    """Batch-sharded plane transform.

    Returns ``fn(xr, xi) -> (yr, yi)`` operating on canonical
    ``(batch, *lengths)`` float planes sharded over ``axis`` on the batch
    dimension.  Each device runs the committed plan's core executor on its
    own slice — no collectives (batch parallelism is embarrassingly
    parallel).
    """
    from ..enums import Direction

    direction = direction or Direction.FORWARD
    ndim = len(committed.descriptor.lengths)
    spec = P(axis, *([None] * ndim))
    bank = replicated_bank(committed._bank_arrays, mesh)
    mapped = _per_shard(
        mesh,
        lambda xr, xi, b: committed._core(xr, xi, direction, b),
        (spec, spec, P()),
        (spec, spec),
    )
    return lambda xr, xi: mapped(xr, xi, bank)


def batch_parallel_real(committed, mesh: Mesh, axis: str, direction=None):
    """Batch-sharded REAL-domain transform (embarrassingly parallel over
    batch, like :func:`batch_parallel`): FORWARD maps a real
    ``(batch, *lengths)`` plane to half-spectrum planes
    ``(batch, ..., n//2+1)``; BACKWARD maps half-spectrum planes back to
    the real plane.  Extension beyond the reference (REAL throws there,
    committed_descriptor.hpp:134-137)."""
    from ..enums import Direction

    direction = direction or Direction.FORWARD
    ndim = len(committed.descriptor.lengths)
    spec = P(axis, *([None] * ndim))
    bank = replicated_bank(committed._bank_arrays, mesh)

    if direction == Direction.FORWARD:
        mapped = _per_shard(
            mesh,
            lambda x, b: committed._core_real_forward(x, b),
            (spec, P()),
            (spec, spec),
        )
        return lambda x, _=None: mapped(x, bank)
    mapped = _per_shard(
        mesh,
        lambda xr, xi, b: committed._core_real_backward(xr, xi, b),
        (spec, spec, P()),
        spec,
    )
    return lambda xr, xi: mapped(xr, xi, bank)


def _balanced_split(n: int, p: int) -> tuple[int, int]:
    """n = G1·G2 with p | G1, p | G2, G1/G2 as balanced as possible."""
    best = None
    for g1 in range(int(math.isqrt(n)), 0, -1):
        if n % g1:
            continue
        g2 = n // g1
        for a, b in ((g1, g2), (g2, g1)):
            if a % p == 0 and b % p == 0:
                if best is None or abs(a - b) < abs(best[0] - best[1]):
                    best = (a, b)
        if best:
            break
    if best is None:
        raise ValueError(
            f"cannot shard n={n} over {p} devices: need a split n=G1*G2 "
            f"with {p} dividing both factors"
        )
    return best


class DistributedFFT:
    """Large-N C2C transform with the transform dimension sharded over a
    mesh axis.

    Input/output: float planes ``(B, n)`` with the last dimension sharded
    over ``seq_axis`` (and optionally batch over ``batch_axis``).

    ``natural_order=False`` skips the final redistribution and returns the
    four-step "transposed" index order X_view[k1, k2] (X[k1 + G1·k2]),
    sharded over k1 — useful when a backward transform follows immediately.
    """

    def __init__(
        self,
        n: int,
        mesh: Mesh,
        *,
        seq_axis: str = "sp",
        batch_axis: Optional[str] = None,
        precision=np.float32,
        natural_order: bool = True,
        device=None,
    ):
        self.n = n
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.batch_axis = batch_axis
        self.natural_order = natural_order
        self.precision = np.dtype(precision)
        from ..exceptions import UnsupportedConfiguration

        if seq_axis not in mesh.shape:
            raise UnsupportedConfiguration(
                f"mesh has no axis {seq_axis!r} (axes: "
                f"{tuple(mesh.shape)})"
            )
        p = mesh.shape[seq_axis]
        self.num_shards = p
        try:
            self.g1, self.g2 = _balanced_split(n, p)
        except ValueError as exc:
            raise UnsupportedConfiguration(str(exc)) from exc

        self._cfg = resolve_device_config(device)
        itemsize = self.precision.itemsize
        self.plan1 = plan_1d(self.g1, self._cfg, itemsize)
        self.plan2 = plan_1d(self.g2, self._cfg, itemsize)

        bank = xla_fft.TwiddleBank(self.precision)
        self._bank_keys: dict = {}
        # The dense (g2, g1) inter-factor table is n complex elements —
        # the one table that scales with the full transform.  Place it
        # sharded over the mesh axis directly (each device holds only its
        # (g2/p, g1) slice); everything else (sub-plan tables) is small
        # and rides the replicated bank.
        self._tw: dict = {}
        t_sharding = NamedSharding(mesh, P(seq_axis, None))
        for sign in (-1, +1):
            xla_fft.collect_bank_keys(self.plan1, sign, bank, self._bank_keys)
            xla_fft.collect_bank_keys(self.plan2, sign, bank, self._bank_keys)
            tkey = bank.twiddle(self.g1, self.g2, sign)
            self._bank_keys[("T", self.g1, self.g2, sign)] = tkey
            self._tw[sign] = tuple(
                jax.device_put(bank.host.pop(tkey + s), t_sharding)
                for s in ("r", "i")
            )
            bank.host.pop(tkey, None)
        # the small sub-plan tables, one copy per device of the mesh
        self._bank_arrays = bank.device_arrays(NamedSharding(mesh, P()))
        self._fns: dict = {}

    # -- sharding specs ------------------------------------------------

    def _x_spec(self) -> P:
        return P(self.batch_axis, self.seq_axis)

    def input_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self._x_spec())

    # -- traced local computation (inside shard_map) ---------------------

    def _local_fn(self, sign: int):
        g1, g2, p = self.g1, self.g2, self.num_shards
        seq = self.seq_axis
        keys = self._bank_keys

        def fn(xr, xi, tw_r, tw_i, bank):
            # local (Bl, n/p) = (Bl, g1/p, g2) slab of the (g1, g2) view
            bl = xr.shape[0]
            xr = xr.reshape(bl, g1 // p, g2)
            xi = xi.reshape(bl, g1 // p, g2)
            # redistribute: full g1, g2/p local
            xr = jax.lax.all_to_all(xr, seq, split_axis=2, concat_axis=1, tiled=True)
            xi = jax.lax.all_to_all(xi, seq, split_axis=2, concat_axis=1, tiled=True)
            # local FFT over g1 (contiguous after transpose)
            xr = jnp.swapaxes(xr, 1, 2)  # (Bl, g2/p, g1)
            xi = jnp.swapaxes(xi, 1, 2)
            xr, xi = xla_fft.exec_plan(xr, xi, self.plan1, sign, keys, bank)
            # inter-factor twiddle W_n^{k1·g2}: tw is the local (g2/p, g1)
            # slice of the (g2, g1) table
            xr, xi = xla_fft.complex_mul(xr, xi, tw_r, tw_i)
            # redistribute: full g2, k1/p local
            xr = jax.lax.all_to_all(xr, seq, split_axis=2, concat_axis=1, tiled=True)
            xi = jax.lax.all_to_all(xi, seq, split_axis=2, concat_axis=1, tiled=True)
            # local FFT over g2
            xr = jnp.swapaxes(xr, 1, 2)  # (Bl, k1/p, g2)
            xi = jnp.swapaxes(xi, 1, 2)
            xr, xi = xla_fft.exec_plan(xr, xi, self.plan2, sign, keys, bank)
            # C[k1, k2]; X[k1 + g1*k2] = C[k1, k2]
            if self.natural_order:
                # natural view (k2, k1): transpose locally then exchange so
                # each shard holds a contiguous k-range
                xr = jnp.swapaxes(xr, 1, 2)  # (Bl, g2, k1/p)
                xi = jnp.swapaxes(xi, 1, 2)
                xr = jax.lax.all_to_all(xr, seq, split_axis=1, concat_axis=2, tiled=True)
                xi = jax.lax.all_to_all(xi, seq, split_axis=1, concat_axis=2, tiled=True)
                # (Bl, g2/p, g1) = natural-order local slab
            return xr.reshape(bl, -1), xi.reshape(bl, -1)

        return fn

    def _build(self, sign: int):
        x_spec = self._x_spec()
        t_spec = P(self.seq_axis, None)
        bank_spec = P()  # replicated (small sub-plan) tables
        tw_r, tw_i = self._tw[sign]

        local = self._local_fn(sign)
        mapped = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(x_spec, x_spec, t_spec, t_spec, bank_spec),
            out_specs=(x_spec, x_spec),
            check_vma=False,
        )

        @jax.jit
        def fn(xr, xi):
            return mapped(xr, xi, tw_r, tw_i, self._bank_arrays)

        return fn

    def _get(self, sign: int):
        if sign not in self._fns:
            self._fns[sign] = self._build(sign)
        return self._fns[sign]

    def forward(self, xr, xi):
        return self._get(-1)(xr, xi)

    def backward(self, xr, xi):
        return self._get(+1)(xr, xi)


class DistributedCommitted:
    """Descriptor-level distributed plan — ``Descriptor.commit(mesh=...)``.

    Makes the distributed path reachable through the public two-phase API.
    Semantics: the canonical ``(batch, n)`` float planes are sharded over
    ``batch_axis``; when ``seq_axis`` is given the transform dimension is
    additionally sharded and executed by :class:`DistributedFFT`'s
    all_to_all four-step, otherwise each device runs its batch slice
    locally (:func:`batch_parallel`).

    Restrictions (validated): 1D COMPLEX descriptors with default PACKED
    layouts and zero offsets — the distributed surface is the canonical
    plane layout; exotic strides stay single-device.
    """

    def __init__(
        self,
        descriptor,
        mesh: Mesh,
        *,
        batch_axis: str = "dp",
        seq_axis: Optional[str] = None,
        device=None,
        **options,
    ):
        from ..enums import Direction, Domain, Layout
        from ..exceptions import UnsupportedConfiguration
        from ..utils.layout import get_layout

        d = descriptor
        if (
            get_layout(d, Direction.FORWARD) != Layout.PACKED
            or get_layout(d, Direction.BACKWARD) != Layout.PACKED
            or d.get_offset(Direction.FORWARD)
            or d.get_offset(Direction.BACKWARD)
        ):
            raise UnsupportedConfiguration(
                "commit(mesh=...) supports descriptors with default "
                "PACKED layouts and zero offsets"
            )
        if seq_axis is not None and (
            len(d.lengths) != 1 or d.domain != Domain.COMPLEX
        ):
            raise UnsupportedConfiguration(
                "sequence sharding (seq_axis=...) supports 1D COMPLEX "
                "descriptors; REAL and multi-dim plans shard over batch"
            )
        self._real = d.domain == Domain.REAL
        if batch_axis is not None and batch_axis not in mesh.shape:
            raise UnsupportedConfiguration(
                f"mesh has no axis {batch_axis!r}"
            )
        bp = mesh.shape[batch_axis] if batch_axis else 1
        if d.number_of_transforms % max(bp, 1):
            raise UnsupportedConfiguration(
                f"number_of_transforms={d.number_of_transforms} is not "
                f"divisible by the {batch_axis!r} mesh axis ({bp})"
            )
        self.descriptor = d
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.seq_axis = seq_axis
        self.precision = np.dtype(d.precision)
        self.committed = None
        self._dfft = None
        if seq_axis is not None:
            # seq-sharded path: do NOT build the single-device plan — a
            # full-n commit would precompute and upload the dense GLOBAL
            # twiddle bank to one device (the memory the sharding exists
            # to avoid); DistributedFFT builds only the sub-plans and
            # places the big table sharded.
            self._dfft = DistributedFFT(
                d.lengths[0],
                mesh,
                seq_axis=seq_axis,
                batch_axis=batch_axis,
                precision=self.precision,
                device=device,
            )
        else:
            from ..committed import CommittedDescriptor

            self.committed = CommittedDescriptor(d, device=device, **options)
        self._fns: dict = {}

    def input_sharding(self) -> NamedSharding:
        """Sharding of the canonical (batch, *lengths) input planes."""
        if self._dfft is not None:
            return self._dfft.input_sharding()
        ndim = len(self.descriptor.lengths)
        return NamedSharding(
            self.mesh, P(self.batch_axis, *([None] * ndim))
        )

    def _fn(self, direction):
        if direction not in self._fns:
            builder = batch_parallel_real if self._real else batch_parallel
            self._fns[direction] = builder(
                self.committed, self.mesh, self.batch_axis, direction
            )
        return self._fns[direction]

    def compute_forward(self, xr, xi=None):
        """Forward transform of sharded canonical (batch, *lengths)
        float planes (REAL plans take the single real plane)."""
        if self._dfft is not None:
            yr, yi = self._dfft.forward(xr, xi)
            return self._scaled(yr, yi, +0)
        from ..enums import Direction

        return self._fn(Direction.FORWARD)(xr, xi)

    def compute_backward(self, xr, xi=None):
        if self._dfft is not None:
            yr, yi = self._dfft.backward(xr, xi)
            return self._scaled(yr, yi, +1)
        from ..enums import Direction

        return self._fn(Direction.BACKWARD)(xr, xi)

    def _scaled(self, yr, yi, bwd: int):
        # DistributedFFT is unscaled; apply the descriptor's scale here
        # (batch_parallel runs the committed core, which already scales).
        scale = (
            self.descriptor.backward_scale
            if bwd
            else self.descriptor.forward_scale
        )
        if scale != 1.0:
            s = np.array(scale, dtype=self.precision)
            yr = yr * s
            yi = yi * s
        return yr, yi
