"""Committed plan: twiddle precompute + jit-specialized executors.

The JAX analogue of the reference's ``committed_descriptor`` /
``committed_descriptor_impl`` pair (committed_descriptor.hpp:58-310,
committed_descriptor_impl.hpp:84-1111).  Commit = plan every dimension
(planner.py), precompute all twiddle/DFT-matrix device arrays (the analogue
of the commit-time twiddle kernels, committed_descriptor_impl.hpp:737-752),
and build jit-compiled compute callables (the analogue of the spec-constant
JIT builds, :522).

Layout handling: the reference threads strides through device-side memory
views (common/memory_views.hpp); here arbitrary strides/distances/offsets are
canonicalized by a gather prologue and scatter epilogue around a packed
(batch, *lengths) core — PACKED and BATCH_INTERLEAVED layouts lower to pure
reshapes/transposes (free or near-free in XLA), only UNPACKED pays a gather.

The reference's 20 ``compute_forward/backward`` overloads (buffer/USM ×
in/out-of-place × interleaved/split) collapse to two methods with optional
split-imaginary and ``out=`` arguments; in-place donates the input buffer to
the compiled computation so XLA reuses its memory on device.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import resolve_device_config
from .enums import ComplexStorage, Direction, Layout, Placement
from .exceptions import InvalidConfiguration, UnsupportedConfiguration
from .ops import xla_fft
from .planner import plan_1d
from .utils.layout import get_layout

from .enums import inv as _inv

_SIGN = {Direction.FORWARD: -1, Direction.BACKWARD: +1}


class CommittedDescriptor:
    """A planned, compiled FFT ready for repeated execution."""

    def __init__(
        self,
        descriptor,
        device=None,
        matmul_precision=None,
        emulate_fp64: Optional[bool] = None,
    ):
        from .utils.logging import trace

        self.descriptor = descriptor
        # Precision of the factor matmuls (None -> HIGHEST; see
        # ops/xla_fft._PRECISIONS for what the other modes mean).
        import os as _os

        if matmul_precision is None:
            matmul_precision = _os.environ.get("PORTFFT_MATMUL_PRECISION")
        if (isinstance(matmul_precision, str)
                and matmul_precision.lower() not in xla_fft._PRECISIONS):
            raise InvalidConfiguration(
                f"matmul_precision {matmul_precision!r} is not one of "
                f"{sorted(xla_fft._PRECISIONS)}"
            )
        self.matmul_precision = matmul_precision
        self.config = resolve_device_config(device)
        self.precision = np.dtype(descriptor.precision)
        itemsize = self.precision.itemsize

        # fp64 runs natively (the reference gates on the fp64 aspect,
        # fft_test_utils.hpp:441-448); jax only carries float64 with x64
        # mode enabled.  An opt-in double-double emulation (ops/df64.py,
        # ~2^-48 effective precision) stands in on devices without it:
        # commit(emulate_fp64=True) or PORTFFT_EMULATE_FP64=1.
        self._df64 = False
        if self.precision == np.float64:
            if emulate_fp64 is None:
                from .utils.logging import _env_flag

                emulate_fp64 = _env_flag("PORTFFT_EMULATE_FP64")
            if emulate_fp64:
                from .enums import Domain as _D

                if descriptor.domain == _D.REAL:
                    # REAL rides the COMPLEX df64 core (zero-imaginary
                    # forward / Hermitian-extended backward); supported
                    # envelope is the plain case
                    if (
                        len(descriptor.lengths) != 1
                        or descriptor.placement == Placement.IN_PLACE
                        or descriptor.complex_storage
                        == ComplexStorage.SPLIT_COMPLEX
                        or get_layout(descriptor, Direction.FORWARD)
                        != Layout.PACKED
                        or get_layout(descriptor, Direction.BACKWARD)
                        != Layout.PACKED
                        # layout classification ignores offsets, but the
                        # df64 REAL path reads/writes from element 0
                        or descriptor.get_offset(Direction.FORWARD)
                        or descriptor.get_offset(Direction.BACKWARD)
                    ):
                        raise UnsupportedConfiguration(
                            "emulated fp64 REAL supports 1D out-of-place "
                            "INTERLEAVED transforms in the default PACKED "
                            "layout with zero offsets"
                        )
                from .ops import df64 as _df64mod

                for ln in set(descriptor.lengths):
                    if ln > 1 and not _df64mod.supported(ln):
                        raise UnsupportedConfiguration(
                            "emulated fp64 supports sizes whose prime "
                            f"factors are <= 128; length {ln} is not"
                        )
                self._df64 = True
            elif not jax.config.jax_enable_x64:
                raise UnsupportedConfiguration(
                    "fp64 transforms require jax_enable_x64"
                )

        # One plan per distinct dimension length (reference plans per
        # dimension, committed_descriptor_impl.hpp:734-753).
        self.plans = {
            n: plan_1d(n, self.config, itemsize)
            for n in set(descriptor.lengths)
        }

        if self._df64:
            # emulated-fp64 path: its own hi/lo split f32 tables in place
            # of the float64 bank
            from .ops import df64 as _df64mod

            self._df64_bank: dict = {}
            self._df64_chains: dict = {}
            for sign in (-1, +1):
                for ln in set(descriptor.lengths):
                    if ln == 1:
                        continue
                    chain, tabs = _df64mod.df64_tables(ln, sign)
                    self._df64_chains[(ln, sign)] = chain
                    for name, arr in tabs.items():
                        self._df64_bank[f"n{ln}s{sign}_{name}"] = jnp.asarray(
                            arr
                        )
            self._bank = None
            self._bank_keys = {}
            self._bank_arrays = {}
            self._compiled = {}
            trace(
                "committed (df64):",
                {n: self._df64_chains.get((n, -1)) for n in set(descriptor.lengths)},
            )
            return

        # Precompute every constant array for both directions (the reference
        # also builds forward and backward variants eagerly,
        # committed_descriptor_impl.hpp:448-532).
        self._bank = xla_fft.TwiddleBank(self.precision)
        self._bank_keys: dict = {}
        for sign in (-1, +1):
            for plan in self.plans.values():
                xla_fft.collect_bank_keys(plan, sign, self._bank, self._bank_keys)
        # REAL domain, even last axis: the packed half-length transform
        # (N/2-point complex FFT + untangle) replaces the zero-imaginary
        # full C2C — half the transform work (classic rfft packing; the
        # reference throws for REAL, committed_descriptor.hpp:134-137).
        # Gated at n ≥ 1024: below that the even/odd strided slicing and
        # untangle passes cost more than the halved matmuls save.
        from .enums import Domain as _Dom

        nlast = descriptor.lengths[-1]
        if (
            _Dom(descriptor.domain) == _Dom.REAL
            and nlast % 2 == 0
            and nlast >= 1024
        ):
            h = nlast // 2
            if h not in self.plans:
                self.plans[h] = plan_1d(h, self.config, itemsize)
            for sign in (-1, +1):
                xla_fft.collect_bank_keys(
                    self.plans[h], sign, self._bank, self._bank_keys
                )
                self._bank_keys[("R", nlast, sign)] = (
                    self._bank.rfft_untangle(nlast, sign)
                )
        self._bank_arrays = self._bank.device_arrays(device)

        self._compiled: dict = {}
        trace(
            "committed:",
            {n: p.describe() for n, p in self.plans.items()},
        )

    # ------------------------------------------------------------------
    # Public API (reference committed_descriptor.hpp:58-310)
    # ------------------------------------------------------------------

    def compute_forward(self, x, x_imag=None, *, out=None, out_imag=None):
        """Forward transform.  INTERLEAVED storage: pass one complex (or
        raw interleaved float) buffer.  SPLIT storage: pass the real and
        imaginary buffers.  ``out`` (and ``out_imag`` for split) scatter the
        result into an existing buffer, preserving unwritten elements."""
        return self._compute(Direction.FORWARD, x, x_imag, out, out_imag)

    def compute_backward(self, x, x_imag=None, *, out=None, out_imag=None):
        """Backward (inverse, unnormalized ×backward_scale) transform."""
        return self._compute(Direction.BACKWARD, x, x_imag, out, out_imag)

    def apply(self, x, x_imag=None, *, direction=Direction.FORWARD):
        """Pure, traceable transform on canonical (batch, *lengths) data.

        Unlike ``compute_forward``/``compute_backward`` (which jit, donate
        and cache per entry), this is a plain traced function: embed it in
        your own ``jax.jit``/``lax.scan`` program, differentiate through it
        (the DFT is linear, so gradients are exact), or compose it with
        sharding.  Scales apply; strides/distances/offsets do NOT (data is
        already canonical).  Pass a complex array, or split re/im planes
        (returns a matching complex array or a (re, im) pair).  A JAX-
        native extension — the reference's compute entry points are always
        queue submissions (committed_descriptor.hpp:58-310)."""
        from .enums import Domain

        if self._df64:
            # Traceable df64: the caller holds double-double data as hi/lo
            # f32 plane pairs (the f64 -> 2xf32 split is host-side numpy,
            # ops/df64.split_f64) — pass x=(re_hi, re_lo),
            # x_imag=(im_hi, im_lo) in canonical (batch, *lengths) shape;
            # returns the matching pair-of-pairs.
            # Composes with user jit/scan exactly like the fp32 apply().
            if self.descriptor.domain != Domain.COMPLEX:
                raise UnsupportedConfiguration(
                    "apply() supports COMPLEX-domain plans; REAL "
                    "transforms go through compute_forward/backward"
                )
            if not (
                isinstance(x, tuple)
                and len(x) == 2
                and isinstance(x_imag, tuple)
                and len(x_imag) == 2
            ):
                raise UnsupportedConfiguration(
                    "apply() on an emulated-fp64 plan takes hi/lo f32 "
                    "plane pairs: x=(re_hi, re_lo), x_imag=(im_hi, im_lo) "
                    "(split on the host with ops.df64.split_f64)"
                )
            d = self.descriptor
            shape = (d.number_of_transforms, *d.lengths)
            planes = [
                jnp.asarray(p).reshape(shape).astype(jnp.float32)
                for p in (*x, *x_imag)
            ]
            core = self._df64_core(direction)
            return core(*planes, self._df64_bank)
        if self.descriptor.domain != Domain.COMPLEX:
            raise UnsupportedConfiguration(
                "apply() supports COMPLEX-domain plans; REAL transforms "
                "go through compute_forward/backward"
            )
        d = self.descriptor
        shape = (d.number_of_transforms, *d.lengths)
        split = x_imag is not None
        if split:
            xr = jnp.asarray(x).reshape(shape).astype(self.precision)
            xi = jnp.asarray(x_imag).reshape(shape).astype(self.precision)
        else:
            z = jnp.asarray(x).reshape(shape)
            xr = jnp.real(z).astype(self.precision)
            xi = jnp.imag(z).astype(self.precision)
        yr, yi = self._core(xr, xi, direction, self._bank_arrays)
        if split:
            return yr, yi
        return jax.lax.complex(yr, yi)

    def plan_description(self) -> dict:
        """Human-readable plan summary (one entry per dimension length)."""
        return {n: p.describe() for n, p in self.plans.items()}

    def clone(self) -> "CommittedDescriptor":
        """Copy sharing the built plan, twiddle arrays and compiled
        executables (reference create_copy shares kernel bundles,
        committed_descriptor_impl.hpp:774-803; with immutable JAX arrays
        there is no scratch to re-allocate)."""
        import copy

        new = copy.copy(self)
        return new

    # ------------------------------------------------------------------
    # Layout canonicalization
    # ------------------------------------------------------------------

    def _indices(self, direction: Direction) -> np.ndarray:
        """(batch, *domain_lengths) element indices into the flat domain
        buffer."""
        d = self.descriptor
        lengths = d.domain_lengths(direction)
        strides = d.get_strides(direction)
        distance = d.get_distance(direction)
        offset = d.get_offset(direction)
        batch = d.number_of_transforms
        idx = offset + distance * np.arange(batch).reshape(
            (batch,) + (1,) * len(lengths)
        )
        for axis, (length, stride) in enumerate(zip(lengths, strides)):
            shape = [1] * (len(lengths) + 1)
            shape[axis + 1] = length
            idx = idx + stride * np.arange(length).reshape(shape)
        # int32 indices halve the gather's index traffic; every reachable
        # buffer is far below 2^31 elements (descriptor validation bounds
        # count by the stride/distance walk).
        if idx.size and idx.max() < 2**31:
            idx = idx.astype(np.int32)
        if idx.size > (1 << 26):  # 64M entries = 256 MB int32
            from .utils.logging import warn

            warn(
                "irregular stride layout materializes a "
                f"{idx.size >> 20}M-entry index array per call; regular "
                "(rectangle) strides run as pure streaming ops instead"
            )
        return idx

    def _index_bound(self, direction: Direction) -> int:
        """Largest element index the layout can touch (host math)."""
        d = self.descriptor
        lengths = d.domain_lengths(direction)
        strides = d.get_strides(direction)
        hi = d.get_offset(direction)
        hi += d.get_distance(direction) * (d.number_of_transforms - 1)
        for length, stride in zip(lengths, strides):
            hi += stride * (length - 1)
        return hi

    def _indices_traced(self, direction: Direction):
        """(batch, *domain_lengths) element indices computed IN-TRACE from
        per-axis iotas — the irregular-layout fallback's index array is
        built on device instead of being baked as a (batch, N) constant
        into the executable (and shipped host->device per compile).  The
        reference's counterpart keeps arbitrary strides inside kernels via
        md_view (memory_views.hpp:126-229); here a transient device array
        stands in.  Returns None when an index
        could overflow int32 (pathological layouts take the host path)."""
        if self._index_bound(direction) >= 2**31:
            return None
        d = self.descriptor
        lengths = d.domain_lengths(direction)
        strides = d.get_strides(direction)
        batch = d.number_of_transforms
        idx = d.get_offset(direction) + d.get_distance(
            direction
        ) * jnp.arange(batch, dtype=jnp.int32).reshape(
            (batch,) + (1,) * len(lengths)
        )
        for axis, (length, stride) in enumerate(zip(lengths, strides)):
            shape = [1] * (len(lengths) + 1)
            shape[axis + 1] = length
            idx = idx + stride * jnp.arange(length, dtype=jnp.int32).reshape(
                shape
            )
        return idx

    def _regular_1d(self, direction: Direction):
        """(offset, stride, distance, n, batch) when the UNPACKED layout is
        a regular 1D rectangle — batch rows of length ``distance`` holding
        one transform each at stride ``stride`` — else None.

        Regularity lets the gather/scatter run as reshape + strided slice /
        masked merge (pure streaming ops, no index arrays): the reference
        moves such layouts inside kernels via md_view strided copies
        (workitem_dispatcher.hpp:162-244, memory_views.hpp:126-229); a
        materialized-index gather would build a (batch, N) int array —
        ~1 GB at bench scale."""
        d = self.descriptor
        # REAL descriptors have different element grids per domain (the
        # spectrum side is n//2+1) — the rectangle must be built from the
        # domain's own length, like _gather/_scatter do.
        lengths = d.domain_lengths(direction)
        if len(lengths) != 1:
            return None
        n = lengths[0]
        s = d.get_strides(direction)[0]
        dist = d.get_distance(direction)
        o = d.get_offset(direction)
        b = d.number_of_transforms
        if s <= 0 or dist <= 0:
            return None
        span = (n - 1) * s + 1
        if b > 1 and span > dist:
            # overlapping rows: reads may legally overlap (inputs), writes
            # cannot (validated) — either way the rectangle view fails.
            return None
        if b == 1:
            # distance is meaningless for one row; clamping to the span
            # keeps the padded rectangle at O(span) no matter what the
            # user declared (a huge declared distance must not size it).
            dist = span
        return o, s, dist, n, b

    def _gather(self, flat, direction: Direction):
        """flat (count,) complex/real -> (batch, *lengths) canonical."""
        d = self.descriptor
        lengths = d.domain_lengths(direction)
        layout = get_layout(d, direction)
        batch = d.number_of_transforms
        n = math.prod(lengths)
        offset = d.get_offset(direction)
        if layout == Layout.PACKED:
            block = jax.lax.dynamic_slice_in_dim(flat, offset, batch * n)
            return block.reshape(batch, *lengths)
        if layout == Layout.BATCH_INTERLEAVED:
            block = jax.lax.dynamic_slice_in_dim(flat, offset, batch * n)
            return block.reshape(n, batch).T.reshape(batch, *lengths)
        reg = self._regular_1d(direction)
        if reg is not None:
            o, s, dist, n1, b = reg
            span = (n1 - 1) * s + 1
            need = (b - 1) * dist + span
            block = jax.lax.dynamic_slice_in_dim(flat, o, need)
            pad = b * dist - need
            if pad > 0:
                block = jnp.pad(block, (0, pad))
            x2 = block.reshape(b, dist)
            return jax.lax.slice(x2, (0, 0), (b, span), (1, s))
        idx = self._indices_traced(direction)
        if idx is None:
            idx = jnp.asarray(self._indices(direction))
        return jnp.take(flat, idx, axis=0)

    def _scatter(self, result, flat_out, direction: Direction):
        """(batch, *lengths) -> flat output buffer (updating flat_out)."""
        d = self.descriptor
        layout = get_layout(d, direction)
        batch = d.number_of_transforms
        n = math.prod(d.domain_lengths(direction))
        offset = d.get_offset(direction)
        if layout == Layout.PACKED:
            if offset == 0 and flat_out.shape[0] == batch * n:
                # Full coverage: the destination buffer is irrelevant.
                return result.reshape(batch * n)
            return jax.lax.dynamic_update_slice_in_dim(
                flat_out, result.reshape(batch * n), offset, axis=0
            )
        if layout == Layout.BATCH_INTERLEAVED:
            block = result.reshape(batch, n).T.reshape(batch * n)
            return jax.lax.dynamic_update_slice_in_dim(
                flat_out, block, offset, axis=0
            )
        reg = self._regular_1d(direction)
        if reg is not None:
            # masked streaming merge: expand result rows to stride-s spacing
            # (trailing pads + reshapes only) and select against the
            # destination rectangle — no scatter, no index arrays.
            o, s, dist, n1, b = reg
            span = (n1 - 1) * s + 1
            need = (b - 1) * dist + span
            block = jax.lax.dynamic_slice_in_dim(flat_out, o, need)
            pad = b * dist - need
            if pad > 0:
                block = jnp.pad(block, (0, pad))
            x2 = block.reshape(b, dist)
            exp = result.reshape(b, n1, 1)
            if s > 1:
                exp = jnp.pad(exp, ((0, 0), (0, 0), (0, s - 1)))
            exp = exp.reshape(b, n1 * s)
            if dist > n1 * s:
                exp = jnp.pad(exp, ((0, 0), (0, dist - n1 * s)))
            col = jnp.arange(dist, dtype=jnp.int32)
            mask = (col % s == 0) & (col < span)
            merged = jnp.where(mask, exp[:, :dist], x2).reshape(b * dist)
            if pad > 0:
                merged = merged[:need]
            return jax.lax.dynamic_update_slice_in_dim(
                flat_out, merged, o, axis=0
            )
        idx = self._indices_traced(direction)
        if idx is None:
            idx = jnp.asarray(self._indices(direction))
        return flat_out.at[idx].set(result)

    # ------------------------------------------------------------------
    # Core traced computation
    # ------------------------------------------------------------------

    def _workspace_len(self) -> int:
        """Largest per-transform intermediate length in the plan tree
        (Bluestein's padded convolution dominates when present)."""

        def walk(p) -> int:
            if p.conv is not None:
                return max(p.n, walk(p.conv))
            if p.sub is not None:
                return max(p.n, walk(p.sub[0]), walk(p.sub[1]))
            return p.n

        total = 1
        for n, p in self.plans.items():
            total = max(total, walk(p) * (self.descriptor.get_flattened_length() // n))
        return total

    def chunk_rows(self, batch: int) -> int:
        """Batch rows per ``lax.map`` chunk when :meth:`_core` runs
        ``batch`` transforms (``batch`` itself when it runs unchunked):
        the largest divisor of ``batch`` whose estimated working set —
        16 bytes of intermediates per scalar of the widest plan level —
        stays within ``config.hbm_chunk_bytes``."""
        per_tx = 16 * self.precision.itemsize * self._workspace_len()
        budget = self.config.hbm_chunk_bytes
        if batch <= 1 or per_tx * batch <= budget:
            return batch
        chunk = max(1, budget // per_tx)
        while chunk > 1 and batch % chunk:
            chunk -= 1
        return chunk

    def _core(self, xr, xi, direction: Direction, bank):
        """(batch, *lengths) re/im -> transformed re/im, scale applied.

        Batches whose intermediate working set exceeds the chunk budget
        run under ``lax.map`` over batch chunks (:meth:`chunk_rows`) —
        memory is reused across chunks inside one executable (reference
        analogue: the global engine's L2-sized batch chunks,
        global_dispatcher.hpp:343).

        Multi-dimensional dispatch: separable per-axis transforms, last
        (contiguous) axis first (reference dispatch_dimensions,
        committed_descriptor_impl.hpp:899-950).
        """
        batch = xr.shape[0]
        chunk = self.chunk_rows(batch)
        if chunk < batch:
            nchunks = batch // chunk
            shape = xr.shape
            xr3 = xr.reshape(nchunks, chunk, *shape[1:])
            xi3 = xi.reshape(nchunks, chunk, *shape[1:])
            yr3, yi3 = jax.lax.map(
                lambda ab: self._core_inner(ab[0], ab[1], direction, bank),
                (xr3, xi3),
            )
            return yr3.reshape(shape), yi3.reshape(shape)
        return self._core_inner(xr, xi, direction, bank)

    def _core_inner(self, xr, xi, direction: Direction, bank):
        d = self.descriptor
        sign = _SIGN[direction]
        ndims = len(d.lengths)
        for axis in range(ndims - 1, -1, -1):
            n = d.lengths[axis]
            if n == 1:
                continue
            plan = self.plans[n]
            if axis != ndims - 1:
                xr = jnp.moveaxis(xr, 1 + axis, -1)
                xi = jnp.moveaxis(xi, 1 + axis, -1)
            xr, xi = xla_fft.exec_plan(
                xr, xi, plan, sign, self._bank_keys, bank,
                self.matmul_precision,
            )
            if axis != ndims - 1:
                xr = jnp.moveaxis(xr, -1, 1 + axis)
                xi = jnp.moveaxis(xi, -1, 1 + axis)
        scale = d.get_scale(direction)
        if scale != 1.0:
            s = np.array(scale, dtype=self.precision)
            xr = xr * s
            xi = xi * s
        return xr, xi

    # ------------------------------------------------------------------
    # REAL domain core (R2C / C2R) — extension beyond the reference, which
    # validates REAL as unsupported (descriptor_validation.hpp:268-270).
    # Convention: forward = real (*lengths) -> conjugate-even half spectrum
    # (last dim n//2+1); backward = the inverse (NumPy rfftn/irfftn).
    # ------------------------------------------------------------------

    def _core_real_forward(self, x, bank):
        """(b, *lengths) real -> half-spectrum planes
        (b, ..., n//2+1)."""
        d = self.descriptor
        sign = -1
        n = d.lengths[-1]
        h = n // 2
        if ("R", n, sign) in self._bank_keys:
            # packed half-length: FFT_{n/2} of z = x_even + i·x_odd, then
            # untangle X[k] = E[k] + W^k·O[k] (k ≤ h, W = e^{-2πi/n})
            zr, zi = xla_fft.exec_plan(
                x[..., 0::2], x[..., 1::2], self.plans[h], sign,
                self._bank_keys, bank, self.matmul_precision,
            )
            rr = jnp.roll(jnp.flip(zr, -1), 1, -1)  # Z[(h-k) mod h]
            ri = jnp.roll(jnp.flip(zi, -1), 1, -1)
            er = 0.5 * (zr + rr)
            ei = 0.5 * (zi - ri)
            our = 0.5 * (zi + ri)
            oui = -0.5 * (zr - rr)
            rkey = self._bank_keys[("R", n, sign)]
            tr, ti = xla_fft.complex_mul(
                our, oui, bank[rkey + "r"], bank[rkey + "i"]
            )
            xr = jnp.concatenate(
                [er + tr, zr[..., :1] - zi[..., :1]], axis=-1
            )
            xi = jnp.concatenate(
                [ei + ti, jnp.zeros_like(zi[..., :1])], axis=-1
            )
        else:
            # odd n: full C2C with zero imaginary, keep bins 0..h
            xr, xi = xla_fft.exec_plan(
                x,
                jnp.zeros_like(x),
                self.plans[n],
                sign,
                self._bank_keys,
                bank,
                self.matmul_precision,
            )
            xr = xr[..., : h + 1]
            xi = xi[..., : h + 1]
        # remaining axes: plain C2C on the half spectrum
        ndims = len(d.lengths)
        for axis in range(ndims - 2, -1, -1):
            ln = d.lengths[axis]
            if ln == 1:
                continue
            xr = jnp.moveaxis(xr, 1 + axis, -1)
            xi = jnp.moveaxis(xi, 1 + axis, -1)
            xr, xi = xla_fft.exec_plan(
                xr, xi, self.plans[ln], sign, self._bank_keys, bank,
                self.matmul_precision,
            )
            xr = jnp.moveaxis(xr, -1, 1 + axis)
            xi = jnp.moveaxis(xi, -1, 1 + axis)
        scale = d.forward_scale
        if scale != 1.0:
            s = np.array(scale, dtype=self.precision)
            xr, xi = xr * s, xi * s
        return xr, xi

    def _core_real_backward(self, xr, xi, bank):
        """Half-spectrum planes (b, ..., n//2+1) -> (b, *lengths) real."""
        d = self.descriptor
        sign = +1
        n = d.lengths[-1]
        h = n // 2
        # other axes first (inverse of the forward ordering)
        ndims = len(d.lengths)
        for axis in range(ndims - 2, -1, -1):
            ln = d.lengths[axis]
            if ln == 1:
                continue
            xr = jnp.moveaxis(xr, 1 + axis, -1)
            xi = jnp.moveaxis(xi, 1 + axis, -1)
            xr, xi = xla_fft.exec_plan(
                xr, xi, self.plans[ln], sign, self._bank_keys, bank,
                self.matmul_precision,
            )
            xr = jnp.moveaxis(xr, -1, 1 + axis)
            xi = jnp.moveaxis(xi, -1, 1 + axis)
        if ("R", n, sign) in self._bank_keys:
            # packed half-length inverse: retangle Z = 2E + 2i·O (the
            # factor 2 absorbs the length ratio n/h of the unnormalized
            # inverse), IDFT_{n/2}, interleave re/im as even/odd samples
            rev_r = jnp.flip(xr[..., 1 : h + 1], axis=-1)  # X[h-k], k<h
            rev_i = jnp.flip(xi[..., 1 : h + 1], axis=-1)
            e2r = xr[..., :h] + rev_r
            e2i = xi[..., :h] - rev_i
            n2r = xr[..., :h] - rev_r
            n2i = xi[..., :h] + rev_i
            rkey = self._bank_keys[("R", n, sign)]  # W^{+k} (sign=+1)
            o2r, o2i = xla_fft.complex_mul(
                n2r, n2i, bank[rkey + "r"], bank[rkey + "i"]
            )
            zr = e2r - o2i
            zi = e2i + o2r
            zr, zi = xla_fft.exec_plan(
                zr, zi, self.plans[h], sign, self._bank_keys, bank,
                self.matmul_precision,
            )
            fr = jnp.stack([zr, zi], axis=-1).reshape(*zr.shape[:-1], n)
        else:
            # Hermitian extension of the last axis: X[n-k] = conj(X[k]),
            # k = 1 .. n - h1 (parity-correct: even n -> h-1 elements,
            # odd n -> h elements)
            h1 = n // 2 + 1
            tail_r = jnp.flip(xr[..., 1 : n - h1 + 1], axis=-1)
            tail_i = -jnp.flip(xi[..., 1 : n - h1 + 1], axis=-1)
            fr = jnp.concatenate([xr, tail_r], axis=-1)
            fi = jnp.concatenate([xi, tail_i], axis=-1)
            fr, fi = xla_fft.exec_plan(
                fr, fi, self.plans[n], sign, self._bank_keys, bank,
                self.matmul_precision,
            )
        scale = d.backward_scale
        if scale != 1.0:
            fr = fr * np.array(scale, dtype=self.precision)
        return fr  # imaginary part is zero by symmetry

    # ------------------------------------------------------------------
    # Compiled entry points
    # ------------------------------------------------------------------

    @staticmethod
    def _deinterleave(raw):
        """(2M,) interleaved scalars -> two (M,) planes."""
        return raw[0::2], raw[1::2]

    @staticmethod
    def _interleave(re, im):
        """Two (M,) planes -> (2M,) interleaved."""
        return jnp.stack([re, im], axis=-1).reshape(-1)

    def _traced_interleaved(self, direction: Direction):
        """Interleaved storage, raw-scalar device buffers.

        The device-side representation of an interleaved complex buffer is a
        flat float array of 2·count scalars — exactly the reference's
        ``Scalar*`` view (committed_descriptor_impl.hpp:1103-1110); complex
        numpy inputs are reinterpreted host-side (zero-copy).
        """

        def fn(raw_in, raw_out, bank):
            in_re, in_im = self._deinterleave(raw_in)
            xr = self._gather(in_re, direction)
            xi = self._gather(in_im, direction)
            yr, yi = self._core(xr, xi, direction, bank)
            # Output lives in the opposite domain's layout (enums.hpp:39).
            out_dir = _inv(direction)
            out_re, out_im = self._deinterleave(raw_out)
            o_re = self._scatter(yr, out_re, out_dir)
            o_im = self._scatter(yi, out_im, out_dir)
            return self._interleave(o_re, o_im)

        return fn

    def _traced_split(self, direction: Direction):
        def fn(flat_re, flat_im, out_re, out_im, bank):
            xr = self._gather(flat_re, direction)
            xi = self._gather(flat_im, direction)
            yr, yi = self._core(xr, xi, direction, bank)
            out_dir = _inv(direction)
            return (
                self._scatter(yr, out_re, out_dir),
                self._scatter(yi, out_im, out_dir),
            )

        return fn

    def _traced_real_forward(self, split: bool):
        if split:

            def fn(real_in, out_re, out_im, bank):
                x = self._gather(real_in, Direction.FORWARD)
                yr, yi = self._core_real_forward(x, bank)
                return (
                    self._scatter(yr, out_re, Direction.BACKWARD),
                    self._scatter(yi, out_im, Direction.BACKWARD),
                )

        else:

            def fn(real_in, raw_out, bank):
                x = self._gather(real_in, Direction.FORWARD)
                yr, yi = self._core_real_forward(x, bank)
                out_re, out_im = self._deinterleave(raw_out)
                o_re = self._scatter(yr, out_re, Direction.BACKWARD)
                o_im = self._scatter(yi, out_im, Direction.BACKWARD)
                return self._interleave(o_re, o_im)

        return fn

    def _traced_real_backward(self, split: bool):
        def fn(in_re, in_im, real_out, bank):
            xr = self._gather(in_re, Direction.BACKWARD)
            xi = self._gather(in_im, Direction.BACKWARD)
            y = self._core_real_backward(xr, xi, bank)
            return self._scatter(y, real_out, Direction.FORWARD)

        return fn

    def _get_compiled(self, key, builder, donate):
        if key not in self._compiled:
            self._compiled[key] = jax.jit(builder(), donate_argnums=donate)
        return self._compiled[key]

    def _run(self, key, builder, donate, *args):
        """Execute the compiled entry point ``key`` (built on first use)."""
        return self._get_compiled(key, builder, donate)(*args)

    # ------------------------------------------------------------------
    # Emulated-fp64 compute (double-double; ops/df64.py)
    # ------------------------------------------------------------------

    def _df64_core(self, direction):
        """Traced (4-plane) transform over every axis for the df64 path."""
        from .ops import df64 as _df64mod

        d = self.descriptor
        sign = _SIGN[direction]
        ndims = len(d.lengths)

        def fn(rh, rl, ih, il, bank):
            x = ((rh, rl), (ih, il))
            for axis in range(ndims - 1, -1, -1):
                n = d.lengths[axis]
                if n == 1:
                    continue
                if axis != ndims - 1:
                    x = tuple(
                        tuple(jnp.moveaxis(p, 1 + axis, -1) for p in pair)
                        for pair in x
                    )
                chain = self._df64_chains[(n, sign)]
                sub = {
                    k[len(f"n{n}s{sign}_") :]: v
                    for k, v in bank.items()
                    if k.startswith(f"n{n}s{sign}_")
                }
                x = _df64mod.exec_chain(x, chain, sub)
                if axis != ndims - 1:
                    x = tuple(
                        tuple(jnp.moveaxis(p, -1, 1 + axis) for p in pair)
                        for pair in x
                    )
            scale = float(d.get_scale(direction))
            if scale != 1.0:
                sh, sl = _df64mod.split_f64(np.float64(scale))
                (xrh, xrl), (xih, xil) = x
                r = _df64mod.mul(xrh, xrl, jnp.float32(sh), jnp.float32(sl))
                i = _df64mod.mul(xih, xil, jnp.float32(sh), jnp.float32(sl))
                x = (r, i)
            return x

        return fn

    def _df64_canonicalize(self, re, im, direction):
        """Host-side canonicalization of the f64 planes to (batch,
        *lengths) without materialized index arrays: PACKED and
        BATCH_INTERLEAVED are views/reshapes, regular 1D strides are a
        strided numpy view, only irregular layouts fall back to the index
        walk.  (The hi/lo f32 split is host-side numpy; everything after
        it is the jitted df64 core.)"""
        d = self.descriptor
        lengths = d.domain_lengths(direction)
        layout = get_layout(d, direction)
        batch = d.number_of_transforms
        n = math.prod(lengths)
        offset = d.get_offset(direction)
        if layout == Layout.PACKED:
            blk = re[offset : offset + batch * n]
            return (
                blk.reshape(batch, *lengths),
                im[offset : offset + batch * n].reshape(batch, *lengths),
            )
        if layout == Layout.BATCH_INTERLEAVED:
            s = (slice(offset, offset + batch * n),)
            return (
                re[s].reshape(n, batch).T.reshape(batch, *lengths),
                im[s].reshape(n, batch).T.reshape(batch, *lengths),
            )
        reg = self._regular_1d(direction)
        if reg is not None:
            o, st, dist, n1, b = reg
            out_r = np.empty((b, n1), re.dtype)
            out_i = np.empty((b, n1), re.dtype)
            for bi in range(b):  # numpy strided views, no index arrays
                base = o + bi * dist
                sl = slice(base, base + (n1 - 1) * st + 1, st)
                out_r[bi] = re[sl]
                out_i[bi] = im[sl]
            return out_r, out_i
        idx = self._indices(direction)
        return re[idx], im[idx]

    def _df64_scatter(self, dst, values, direction) -> None:
        """Write canonical (batch·n,) host values into the flat buffer
        ``dst`` without materializing index arrays for PACKED / BI /
        regular-strided layouts (symmetric to _df64_canonicalize; only
        irregular layouts pay the index walk)."""
        d = self.descriptor
        lengths = d.domain_lengths(direction)
        layout = get_layout(d, direction)
        batch = d.number_of_transforms
        n = math.prod(lengths)
        offset = d.get_offset(direction)
        v = np.asarray(values).reshape(batch, n)
        if layout == Layout.PACKED:
            dst[offset : offset + batch * n] = v.reshape(-1)
            return
        if layout == Layout.BATCH_INTERLEAVED:
            dst[offset : offset + batch * n] = v.T.reshape(-1)
            return
        reg = self._regular_1d(direction)
        if reg is not None:
            o, st, dist, n1, b = reg
            for bi in range(b):
                base = o + bi * dist
                dst[base : base + (n1 - 1) * st + 1 : st] = v[bi]
            return
        idx = self._indices(direction)
        dst[idx] = v.reshape(idx.shape)

    def _compute_df64_real(self, direction, x, x_imag, out):
        """R2C/C2R under the double-double emulation: the real transform
        rides the COMPLEX df64 core — zero-imaginary forward, Hermitian-
        extended backward — at the same ~2^-48 effective precision.
        Envelope (validated at commit): 1D, out-of-place, INTERLEAVED
        storage, default PACKED layout.  Extension beyond the reference
        (committed_descriptor.hpp:134-137 throws for REAL)."""
        from .ops import df64 as _df64mod

        d = self.descriptor
        n = d.lengths[-1]
        h1 = n // 2 + 1
        b = d.number_of_transforms
        if x_imag is not None:
            raise InvalidConfiguration(
                "REAL df64 input is a single buffer"
            )
        if out is not None:
            raise UnsupportedConfiguration(
                "out= is not supported on the df64 REAL path"
            )
        if direction == Direction.FORWARD:
            xr = np.asarray(x, np.float64).reshape(-1)
            if xr.shape[0] < b * n:
                raise InvalidConfiguration(
                    f"input buffer needs {b * n} real elements"
                )
            xr = np.ascontiguousarray(xr[: b * n].reshape(b, n))
            xi = np.zeros_like(xr)
        else:
            z = np.asarray(x)
            if np.iscomplexobj(z):
                flat = np.ascontiguousarray(z).view(np.float64).reshape(-1)
            else:
                flat = np.asarray(z, np.float64).reshape(-1)
            if flat.shape[0] < 2 * b * h1:
                raise InvalidConfiguration(
                    f"input buffer needs {b * h1} complex elements"
                )
            zr = flat[0::2][: b * h1].reshape(b, h1)
            zi = flat[1::2][: b * h1].reshape(b, h1)
            # Hermitian extension X[n-k] = conj(X[k]), k = 1..n/2-1
            xr = np.concatenate([zr, zr[:, 1 : n - h1 + 1][:, ::-1]], axis=1)
            xi = np.concatenate(
                [zi, -zi[:, 1 : n - h1 + 1][:, ::-1]], axis=1
            )
        rh, rl = _df64mod.split_f64(xr)
        ih, il = _df64mod.split_f64(xi)
        key = ("df64real", direction, xr.shape)
        fn = self._get_compiled(key, lambda: self._df64_core(direction), ())
        (yrh, yrl), (yih, yil) = fn(
            jnp.asarray(rh), jnp.asarray(rl), jnp.asarray(ih),
            jnp.asarray(il), self._df64_bank,
        )
        yr = _df64mod.join_f64(np.asarray(yrh), np.asarray(yrl))
        if direction == Direction.FORWARD:
            yi = _df64mod.join_f64(np.asarray(yih), np.asarray(yil))
            o = np.empty((b, h1), np.complex128)
            o.real = yr[:, :h1]
            o.imag = yi[:, :h1]
            return o.reshape(-1)
        return np.ascontiguousarray(yr).reshape(-1)

    def _compute_df64(self, direction, x, x_imag, out, out_imag):
        """Out-of-core host canonicalization around the jitted df64 core:
        gather/scatter and hi/lo splitting run in numpy (this path is
        correctness-oriented capability, not a bandwidth path)."""
        from .enums import Domain
        from .ops import df64 as _df64mod

        d = self.descriptor
        if d.domain == Domain.REAL:
            return self._compute_df64_real(direction, x, x_imag, out)
        split_store = d.complex_storage == ComplexStorage.SPLIT_COMPLEX
        if split_store:
            if x_imag is None:
                raise InvalidConfiguration(
                    "SPLIT_COMPLEX storage requires both buffers"
                )
            re = np.asarray(x, np.float64).reshape(-1)
            im = np.asarray(x_imag, np.float64).reshape(-1)
        else:
            if x_imag is not None:
                raise InvalidConfiguration(
                    "INTERLEAVED_COMPLEX storage takes a single complex "
                    "buffer"
                )
            xx = np.asarray(x)
            if np.iscomplexobj(xx):
                flat = np.ascontiguousarray(xx).view(np.float64).reshape(-1)
            else:
                flat = np.asarray(xx, np.float64).reshape(-1)
            re, im = flat[0::2], flat[1::2]
        need_in = d.get_input_count(direction)
        if re.shape[0] < need_in:
            raise InvalidConfiguration(
                f"input buffer needs {need_in} complex elements"
            )
        xr, xi = self._df64_canonicalize(re, im, direction)
        rh, rl = _df64mod.split_f64(xr)
        ih, il = _df64mod.split_f64(xi)

        key = ("df64", direction, xr.shape)
        fn = self._get_compiled(key, lambda: self._df64_core(direction), ())
        (yrh, yrl), (yih, yil) = fn(
            jnp.asarray(rh), jnp.asarray(rl), jnp.asarray(ih),
            jnp.asarray(il), self._df64_bank,
        )
        yr = _df64mod.join_f64(np.asarray(yrh), np.asarray(yrl))
        yi = _df64mod.join_f64(np.asarray(yih), np.asarray(yil))

        out_dir = _inv(direction)
        need_out = d.get_output_count(direction)
        in_place = d.placement == Placement.IN_PLACE
        if split_store:
            if isinstance(out, tuple) and out_imag is None:
                out, out_imag = out  # (re, im) pair like _compute_split
            if in_place:
                o_re, o_im = re.copy(), im.copy()
            else:
                o_re = (
                    np.asarray(out, np.float64).reshape(-1).copy()
                    if out is not None
                    else np.zeros(need_out, np.float64)
                )
                o_im = (
                    np.asarray(out_imag, np.float64).reshape(-1).copy()
                    if out_imag is not None
                    else np.zeros(need_out, np.float64)
                )
            if o_re.shape[0] < need_out or o_im.shape[0] < need_out:
                raise InvalidConfiguration(
                    f"split output buffers need {need_out} elements"
                )
            self._df64_scatter(o_re, yr, out_dir)
            self._df64_scatter(o_im, yi, out_dir)
            return o_re, o_im
        if in_place:
            o = flat.copy()  # preserve gap elements of the shared buffer
        elif out is not None:
            oo = np.asarray(out)
            o = (
                np.ascontiguousarray(oo).view(np.float64).reshape(-1).copy()
                if np.iscomplexobj(oo)
                else np.asarray(oo, np.float64).reshape(-1).copy()
            )
        else:
            o = np.zeros(2 * need_out, np.float64)
        if o.shape[0] < 2 * need_out:
            raise InvalidConfiguration(
                f"output buffer needs {need_out} complex elements"
            )
        self._df64_scatter(o[0::2], yr, out_dir)
        self._df64_scatter(o[1::2], yi, out_dir)
        return o.view(np.complex128)

    def _compute(self, direction, x, x_imag, out, out_imag):
        d = self.descriptor
        if d.placement == Placement.IN_PLACE and (
            out is not None or out_imag is not None
        ):
            raise InvalidConfiguration(
                "out= must not be given for an IN_PLACE committed descriptor"
            )
        if self._df64:
            return self._compute_df64(direction, x, x_imag, out, out_imag)
        from .enums import Domain

        if d.domain == Domain.REAL:
            return self._compute_real(direction, x, x_imag, out, out_imag)
        if d.complex_storage == ComplexStorage.SPLIT_COMPLEX:
            if x_imag is None:
                raise InvalidConfiguration(
                    "SPLIT_COMPLEX storage requires both real and imaginary "
                    "buffers"
                )
            return self._compute_split(direction, x, x_imag, out, out_imag)
        if x_imag is not None:
            raise InvalidConfiguration(
                "INTERLEAVED_COMPLEX storage takes a single complex buffer"
            )
        return self._compute_interleaved(direction, x, out)

    def _compute_real(self, direction, x, x_imag, out, out_imag):
        """R2C forward / C2R backward dispatch (out-of-place only).

        Forward: ``x`` is a real buffer; the result is the half spectrum in
        the descriptor's complex storage (complex array for INTERLEAVED
        given numpy input, raw float pairs for jax input; (re, im) planes
        for SPLIT).  Backward: the reverse."""
        d = self.descriptor
        split = d.complex_storage == ComplexStorage.SPLIT_COMPLEX
        real_count = d.get_input_count(Direction.FORWARD)
        cplx_count = d.get_input_count(Direction.BACKWARD)

        if direction == Direction.FORWARD:
            if x_imag is not None:
                raise InvalidConfiguration(
                    "REAL domain forward input is a single real buffer"
                )
            real_in = jnp.asarray(x).reshape(-1)
            if jnp.iscomplexobj(real_in):
                raise InvalidConfiguration(
                    "REAL domain forward input must be a real buffer"
                )
            if real_in.shape[0] < real_count:
                raise InvalidConfiguration(
                    f"real input buffer needs {real_count} elements"
                )
            if split:
                if isinstance(out, tuple) and out_imag is None:
                    out, out_imag = out
                o_re = (
                    jnp.asarray(out).reshape(-1)
                    if out is not None
                    else jnp.zeros(cplx_count, dtype=self.precision)
                )
                o_im = (
                    jnp.asarray(out_imag).reshape(-1)
                    if out_imag is not None
                    else jnp.zeros(cplx_count, dtype=self.precision)
                )
                key = ("r2c_split", real_in.shape, o_re.shape)
                return self._run(
                    key,
                    lambda: self._traced_real_forward(True),
                    (),
                    real_in,
                    o_re,
                    o_im,
                    self._bank_arrays,
                )
            # interleaved
            was_numpy = isinstance(x, np.ndarray)
            if d.placement == Placement.IN_PLACE:
                # FFTW padded layout: the half spectrum overwrites the
                # padded real buffer (validation pinned the distances)
                if real_in.shape[0] < 2 * cplx_count:
                    raise InvalidConfiguration(
                        "in-place REAL buffer needs "
                        f"{2 * cplx_count} real elements (padded rows of "
                        "2*(n/2+1))"
                    )
                raw_out = real_in
            elif out is not None:
                raw_out, _ = self._to_raw(out)
            else:
                raw_out = jnp.zeros(2 * cplx_count, dtype=self.precision)
            key = ("r2c_raw", real_in.shape, raw_out.shape)
            result = self._run(
                key,
                lambda: self._traced_real_forward(False),
                (),
                real_in,
                raw_out,
                self._bank_arrays,
            )
            if was_numpy:
                return np.asarray(result).view(self._complex_dtype())
            return result

        # BACKWARD: complex half-spectrum in, real out
        if split:
            if x_imag is None:
                raise InvalidConfiguration(
                    "SPLIT_COMPLEX backward input needs re and im buffers"
                )
            in_re = jnp.asarray(x).reshape(-1)
            in_im = jnp.asarray(x_imag).reshape(-1)
        else:
            if x_imag is not None:
                raise InvalidConfiguration(
                    "INTERLEAVED_COMPLEX input is a single buffer"
                )
            raw_in, _ = self._to_raw(x)
            in_re, in_im = self._deinterleave(raw_in)
        if in_re.shape[0] < cplx_count:
            raise InvalidConfiguration(
                f"half-spectrum input needs {cplx_count} complex elements"
            )
        if d.placement == Placement.IN_PLACE:
            # the padded real rows overwrite the spectrum in the same
            # buffer; gap scalars (the 2-element row pads) are preserved
            real_out = raw_in
        elif out is not None:
            real_out = jnp.asarray(out).reshape(-1)
        else:
            real_out = jnp.zeros(real_count, dtype=self.precision)
        key = ("c2r", in_re.shape, real_out.shape, split)
        return self._run(
            key,
            lambda: self._traced_real_backward(split),
            (),
            in_re,
            in_im,
            real_out,
            self._bank_arrays,
        )

    def _complex_dtype(self):
        return np.dtype(
            np.complex64 if self.precision == np.float32 else np.complex128
        )

    def _to_raw(self, x):
        """Any accepted interleaved buffer -> flat float array of 2·count
        scalars on device.  Returns (raw, was_complex_numpy, was_complex_jax).
        """
        if isinstance(x, np.ndarray) and np.iscomplexobj(x):
            # Interleaved complex IS adjacent (re, im) scalar pairs: a
            # host-side dtype view is zero-copy.
            return (
                jnp.asarray(np.ascontiguousarray(x).view(self.precision).reshape(-1)),
                "np_complex",
            )
        if isinstance(x, jax.Array) and jnp.iscomplexobj(x):
            flat = x.reshape(-1)
            return self._interleave(flat.real, flat.imag), "jax_complex"
        x = jnp.asarray(x)
        if jnp.iscomplexobj(x):
            flat = x.reshape(-1)
            return self._interleave(flat.real, flat.imag), "jax_complex"
        if x.size % 2:
            raise InvalidConfiguration(
                "raw interleaved buffer must have an even number of scalars"
            )
        return x.reshape(-1), "raw"

    def _from_raw(self, raw, kind):
        if kind == "np_complex":
            return np.asarray(raw).view(self._complex_dtype())
        if kind == "jax_complex":
            re, im = self._deinterleave(raw)
            return jax.lax.complex(re, im)
        return raw

    def _compute_interleaved(self, direction, x, out):
        d = self.descriptor
        flat_in, kind = self._to_raw(x)

        need_in = d.get_input_count(direction)
        if flat_in.shape[0] < 2 * need_in:
            raise InvalidConfiguration(
                f"input buffer has {flat_in.shape[0] // 2} complex elements, "
                f"needs {need_in}"
            )

        need_out = d.get_output_count(direction)
        in_place = d.placement == Placement.IN_PLACE
        if in_place:
            flat_out = flat_in
        elif out is not None:
            flat_out, _ = self._to_raw(out)
            if flat_out.shape[0] < 2 * need_out:
                raise InvalidConfiguration(
                    f"output buffer has {flat_out.shape[0] // 2} complex "
                    f"elements, needs {need_out}"
                )
        else:
            flat_out = jnp.zeros(2 * need_out, dtype=self.precision)

        if in_place:
            # one buffer, one donated argnum: passing the same array at
            # two argnums with both donated is an aliasing error on
            # backends with real donation — bind raw_out = raw_in inside
            # the trace instead.
            inner_builder = lambda: self._traced_interleaved(direction)  # noqa: E731

            def builder():
                inner = inner_builder()
                return lambda raw, bank: inner(raw, raw, bank)

            key = ("ileaved_ip", direction, flat_in.shape)
            result = self._run(
                key,
                builder,
                (0,) if jax.default_backend() != "cpu" else (),
                flat_in,
                self._bank_arrays,
            )
            return self._from_raw(result, kind)

        key = ("ileaved", direction, flat_in.shape, flat_out.shape,
               out is None)
        # donate the output buffer only when the library allocated it — a
        # user-supplied jax out= array must stay alive for the caller
        donate = (1,) if out is None else ()
        result = self._run(
            key,
            lambda: self._traced_interleaved(direction),
            donate if jax.default_backend() != "cpu" else (),
            flat_in,
            flat_out,
            self._bank_arrays,
        )
        return self._from_raw(result, kind)

    def _compute_split(self, direction, x_re, x_im, out, out_imag):
        d = self.descriptor
        flat_re = jnp.asarray(x_re).reshape(-1)
        flat_im = jnp.asarray(x_im).reshape(-1)
        need_in = d.get_input_count(direction)
        if flat_re.shape[0] < need_in or flat_im.shape[0] < need_in:
            raise InvalidConfiguration(
                f"split input buffers need {need_in} elements"
            )
        need_out = d.get_output_count(direction)
        in_place = d.placement == Placement.IN_PLACE
        if isinstance(out, tuple) and out_imag is None:
            out, out_imag = out
        if in_place:
            o_re, o_im = flat_re, flat_im
        elif out is not None:
            o_re = jnp.asarray(out).reshape(-1)
            o_im = jnp.asarray(out_imag).reshape(-1)
            if o_re.shape[0] < need_out or o_im.shape[0] < need_out:
                raise InvalidConfiguration(
                    f"split output buffers need {need_out} elements"
                )
        else:
            o_re = jnp.zeros(need_out, dtype=self.precision)
            o_im = jnp.zeros(need_out, dtype=self.precision)

        if in_place:
            # same aliasing rule as the interleaved path: bind the output
            # planes to the input planes inside the trace, donate each
            # buffer exactly once
            inner_builder = lambda: self._traced_split(direction)  # noqa: E731

            def builder():
                inner = inner_builder()
                return lambda re, im, bank: inner(re, im, re, im, bank)

            key = ("split_ip", direction, flat_re.shape)
            return self._run(
                key,
                builder,
                (0, 1) if jax.default_backend() != "cpu" else (),
                flat_re,
                flat_im,
                self._bank_arrays,
            )

        key = ("split", direction, flat_re.shape, o_re.shape, out is None)
        donate = (2, 3) if out is None else ()
        return self._run(
            key,
            lambda: self._traced_split(direction),
            donate if jax.default_backend() != "cpu" else (),
            flat_re,
            flat_im,
            o_re,
            o_im,
            self._bank_arrays,
        )
