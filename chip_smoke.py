#!/usr/bin/env python
"""On-card smoke test of the describe → commit → execute path at real sizes.

    python chip_smoke.py          # one GPU: every single-card phase
    python chip_smoke.py --four   # four GPUs: the sharded paths only

Each phase drives the public API — ``Descriptor(...).commit()`` →
``compute_forward``/``compute_backward``, the ``functional`` API, and
``plan.apply`` inside a user ``jax.jit`` with ``jax.grad`` through it — on
about 1 GiB of input made on the device from ``--seed``.  It then

* checks the output against a complex128 NumPy reference on seeded rows
  (:func:`check_rows`) and checks that the whole output is finite;
* times the library and the same transform through ``jnp.fft`` (cuFFT) on
  the same data in the same process: the median of ``--iters`` calls, each
  ended by ``block_until_ready``, after a warm-up call;
* prints the process's peak device memory and whether the batch ran in
  ``lax.map`` chunks.

One more phase per size runs the reduced ``matmul_precision`` modes and
passes only when the check rejects them (:meth:`Smoke.precision_modes`).

The first line printed is the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them.  The script exits 2 before any phase when JAX finds no GPU, and 1
when any phase failed; otherwise its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``
with the number of cards the run used: 1, or 4 with ``--four``.  One
process drives the card(s).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import sys
import time
import traceback

import numpy as np

GIB = 1 << 30
#: Relative-L2 bound factor: the check requires
#: ||got - ref|| / ||ref|| <= L2_FACTOR · eps · log2(n).  A float32 run at
#: Precision.HIGHEST measures 6e-8..6e-7 on the CPU at the sizes below;
#: rounding the input alone to TF32's 10-bit mantissa gives 1.8e-4, so a
#: TF32 result fails the bound at every size up to n = 2^24 (bound 4.6e-5).
L2_FACTOR = 16.0
#: Host-side reference rows are capped at this many points per phase.
MAX_REF_POINTS = 1 << 26


def check_rows(got, ref, n: int, dtype) -> dict:
    """Compare transformed rows with their complex128 reference.

    Two bounds, both required: the oracle's per-element
    ``2·eps·n·log2(n)`` absolute-or-relative tolerance (tests/oracle.py,
    from the reference's fft_test_utils.hpp:461-464), and a relative L2
    bound of ``L2_FACTOR·eps·log2(n)`` over all checked rows, which a
    TF32 (about 1e-3 relative) result fails.  ``n`` is the flattened
    transform length; ``dtype`` the float type the transform ran in."""
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    eps = float(np.finfo(dtype).eps)
    log2n = max(math.log2(n), 1.0)
    tol = 2.0 * eps * n * log2n
    diff = np.abs(got - ref)
    # per element: diff <= tol (absolute) or diff <= tol·|ref| (relative)
    ratio = diff / (tol * np.maximum(1.0, np.abs(ref)))
    elem = float(ratio.max()) if ratio.size else 0.0
    rel_l2 = float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-300))
    l2_bound = L2_FACTOR * eps * log2n
    return {
        "elem_ratio": elem,
        "rel_l2": rel_l2,
        "l2_bound": l2_bound,
        "ok": bool(elem <= 1.0 and rel_l2 <= l2_bound and np.isfinite(rel_l2)),
    }


def sample_rows(batch: int, n: int, seed: int) -> np.ndarray:
    """Seeded sorted row indices to check: at least 512 rows (all of a
    smaller batch), more for short transforms, at most MAX_REF_POINTS
    points; always the first and last row."""
    want = min(batch, max(512, (1 << 22) // n), max(2, MAX_REF_POINTS // n))
    rng = np.random.default_rng(seed)
    rows = rng.choice(batch, size=want, replace=False)
    return np.unique(np.concatenate([rows, [0, batch - 1]]))


class Smoke:
    """Runs the phases in one process and records what each measured."""

    def __init__(self, seed: int, iters: int):
        import jax

        self.jax = jax
        self.seed = seed
        self.iters = iters
        self.dev = jax.devices()[0]
        self.failed: list[str] = []
        self._key = jax.random.PRNGKey(seed)

    # -- helpers -------------------------------------------------------

    def key(self):
        self._key, sub = self.jax.random.split(self._key)
        return sub

    def uniform(self, shape, dtype=np.float32):
        return self.jax.random.uniform(
            self.key(), shape, dtype=dtype, minval=-1.0, maxval=1.0
        )

    def time_ms(self, fn, *args) -> float:
        """Median ms per call after one warm-up call."""
        jax = self.jax
        jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(self.iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(ts)

    def first_call(self, fn, *args):
        """(result, seconds) of the first call: compile plus one run."""
        t0 = time.perf_counter()
        out = self.jax.block_until_ready(fn(*args))
        return out, time.perf_counter() - t0

    def peak_gib(self) -> str:
        stats = self.dev.memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        return "n/a" if peak is None else f"{peak / GIB:.2f}"

    def finite(self, *arrays) -> bool:
        jnp = self.jax.numpy
        return all(bool(jnp.all(jnp.isfinite(a))) for a in arrays)

    def report(self, name, check, lib_ms, ref_ms, extra="") -> None:
        status = "PASS" if check["ok"] else "FAIL"
        print(
            f"[{status}] {name}: elem/tol={check['elem_ratio']:.3g} "
            f"rel_l2={check['rel_l2']:.3g} (bound {check['l2_bound']:.3g})"
            f"  lib {lib_ms:.3f} ms  jnp.fft {ref_ms:.3f} ms "
            f"(lib/jnp {lib_ms / ref_ms:.2f})  peak {self.peak_gib()} GiB"
            f"{extra}",
            flush=True,
        )
        if not check["ok"]:
            raise AssertionError(f"{name}: output outside the bound {check}")

    def run(self, name, fn) -> None:
        try:
            fn()
        except Exception:
            self.failed.append(name)
            print(f"[FAIL] {name}: exception", flush=True)
            traceback.print_exc()
        finally:
            import portfft_tpu.functional as F

            F.clear_plan_cache()
            gc.collect()

    # -- single-card phases ----------------------------------------------

    def c2c(self, n, batch, direction="forward", unchunked=False):
        """Interleaved C2C through compute_forward/compute_backward on a
        raw float32 device buffer (the zero-conversion path)."""
        import dataclasses

        import jax.numpy as jnp

        import portfft_tpu as pfft

        jax = self.jax
        desc = pfft.Descriptor(lengths=[n], number_of_transforms=batch)
        plan = desc.commit()
        raw = self.uniform((2 * batch * n,))
        compute = (
            plan.compute_forward if direction == "forward"
            else plan.compute_backward
        )
        y, first_s = self.first_call(compute, raw)
        if not self.finite(y):
            raise AssertionError("non-finite output")
        rows = sample_rows(batch, n, self.seed)
        x_rows = self._rows(raw, batch, n, rows)
        y_rows = self._rows(y, batch, n, rows)
        if direction == "forward":
            ref = np.fft.fft(x_rows, axis=1)
        else:
            ref = np.fft.ifft(x_rows, axis=1) * n
        check = check_rows(y_rows, ref, n, np.float32)

        jfft = jnp.fft.fft if direction == "forward" else jnp.fft.ifft
        z = self.as_complex(raw, (batch, n))
        ref_fn = jax.jit(lambda a: jfft(a, axis=-1))
        lib_ms = self.time_ms(compute, raw)
        ref_ms = self.time_ms(ref_fn, z)
        chunk = plan.chunk_rows(batch)
        extra = (
            f"  plan {plan.plans[n].describe()}  chunked="
            + (f"yes ({batch // chunk} x {chunk} rows)" if chunk < batch
               else "no")
            + f"  first call {first_s:.1f} s"
        )
        if unchunked and chunk < batch:
            # the same transform with the chunk budget lifted: what the
            # 2 GiB lax.map chunking costs or saves at this size
            cfg = dataclasses.replace(
                pfft.DeviceConfig(), hbm_chunk_bytes=1 << 62
            )
            plan_u = desc.commit(device=cfg)
            y_u = plan_u.compute_forward(raw)
            check_u = check_rows(
                self._rows(y_u, batch, n, rows), ref, n, np.float32
            )
            if not check_u["ok"] or not self.finite(y_u):
                raise AssertionError(f"unchunked run failed {check_u}")
            del y_u
            extra += f"  unchunked {self.time_ms(plan_u.compute_forward, raw):.3f} ms"
        self.report(
            f"c2c {direction} N={n} batch={batch}", check, lib_ms, ref_ms,
            extra,
        )

    def as_complex(self, raw, shape):
        """A raw interleaved device buffer as a complex array of ``shape``
        (the input ``jnp.fft`` is timed on)."""
        return self.jax.jit(
            lambda r: self.jax.lax.complex(r[0::2], r[1::2]).reshape(shape)
        )(raw)

    @staticmethod
    def _rows(raw, batch, n, rows, dtype=np.complex64):
        """Rows of a raw interleaved device buffer as host complex128."""
        import jax.numpy as jnp

        sel = jnp.asarray(raw).reshape(batch, -1)[jnp.asarray(rows)]
        return np.asarray(sel).view(dtype).astype(np.complex128)

    def real(self, n, batch):
        """REAL R2C forward, then C2R backward of that spectrum."""
        import jax.numpy as jnp

        import portfft_tpu as pfft

        jax = self.jax
        h1 = n // 2 + 1
        plan = pfft.Descriptor(
            lengths=[n], number_of_transforms=batch, domain=pfft.Domain.REAL
        ).commit()
        x = self.uniform((batch * n,))
        spec, first_s = self.first_call(plan.compute_forward, x)
        back = plan.compute_backward(spec)
        if not self.finite(spec, back):
            raise AssertionError("non-finite output")
        rows = sample_rows(batch, n, self.seed)
        x_rows = np.asarray(x.reshape(batch, n)[jnp.asarray(rows)]).astype(
            np.float64
        )
        s_rows = self._rows(spec, batch, h1, rows)
        check_f = check_rows(s_rows, np.fft.rfft(x_rows, axis=1), n, np.float32)
        b_rows = np.asarray(back.reshape(batch, n)[jnp.asarray(rows)])
        check_b = check_rows(
            b_rows, np.fft.irfft(s_rows, n, axis=1) * n, n, np.float32
        )
        xr2 = x.reshape(batch, n)
        zc = self.as_complex(spec, (batch, h1))
        lib_f = self.time_ms(plan.compute_forward, x)
        ref_f = self.time_ms(jax.jit(lambda a: jnp.fft.rfft(a, axis=-1)), xr2)
        lib_b = self.time_ms(plan.compute_backward, spec)
        ref_b = self.time_ms(
            jax.jit(lambda a: jnp.fft.irfft(a, n, axis=-1)), zc
        )
        desc = plan.plan_description()
        self.report(
            f"real R2C N={n} batch={batch}", check_f, lib_f, ref_f,
            f"  plan {desc}  first call {first_s:.1f} s",
        )
        self.report(f"real C2R N={n} batch={batch}", check_b, lib_b, ref_b)

    def multidim(self, lengths, batch):
        import jax.numpy as jnp

        import portfft_tpu as pfft

        jax = self.jax
        n = math.prod(lengths)
        plan = pfft.Descriptor(
            lengths=list(lengths), number_of_transforms=batch
        ).commit()
        raw = self.uniform((2 * batch * n,))
        y, first_s = self.first_call(plan.compute_forward, raw)
        if not self.finite(y):
            raise AssertionError("non-finite output")
        rows = sample_rows(batch, n, self.seed)
        axes = tuple(range(1, 1 + len(lengths)))
        shape = (len(rows), *lengths)
        ref = np.fft.fftn(
            self._rows(raw, batch, n, rows).reshape(shape), axes=axes
        )
        got = self._rows(y, batch, n, rows).reshape(shape)
        check = check_rows(got.reshape(len(rows), -1),
                           ref.reshape(len(rows), -1), n, np.float32)
        z = self.as_complex(raw, (batch, *lengths))
        lib_ms = self.time_ms(plan.compute_forward, raw)
        ref_ms = self.time_ms(jax.jit(lambda a: jnp.fft.fftn(a, axes=axes)), z)
        chunk = plan.chunk_rows(batch)
        self.report(
            f"multi-dim {'x'.join(map(str, lengths))} batch={batch}",
            check, lib_ms, ref_ms,
            f"  chunked={'yes' if chunk < batch else 'no'}"
            f"  first call {first_s:.1f} s",
        )

    def strided(self, n, batch, stride):
        """UNPACKED input: transform b reads elements b·stride·n + stride·j."""
        import jax.numpy as jnp

        import portfft_tpu as pfft

        jax = self.jax
        dist = stride * n
        desc = pfft.Descriptor(
            lengths=[n], number_of_transforms=batch,
            forward_strides=[stride], forward_distance=dist,
            backward_strides=[1], backward_distance=n,
        )
        plan = desc.commit()
        count = desc.get_input_count(pfft.Direction.FORWARD)
        raw = self.uniform((2 * count,))
        y, first_s = self.first_call(plan.compute_forward, raw)
        if not self.finite(y):
            raise AssertionError("non-finite output")

        def gather(r):
            z = jax.lax.complex(r[0::2], r[1::2])
            z = jnp.pad(z, (0, batch * dist - count))
            return z.reshape(batch, dist)[:, ::stride]

        xg = jax.jit(gather)(raw)
        rows = sample_rows(batch, n, self.seed)
        x_rows = np.asarray(xg[jnp.asarray(rows)]).astype(np.complex128)
        check = check_rows(
            self._rows(y, batch, n, rows), np.fft.fft(x_rows, axis=1), n,
            np.float32,
        )
        lib_ms = self.time_ms(plan.compute_forward, raw)
        ref_ms = self.time_ms(
            jax.jit(lambda r: jnp.fft.fft(gather(r), axis=-1)), raw
        )
        self.report(
            f"strided input stride={stride} N={n} batch={batch}", check,
            lib_ms, ref_ms, f"  first call {first_s:.1f} s",
        )

    def split(self, n, batch):
        import jax.numpy as jnp

        import portfft_tpu as pfft

        jax = self.jax
        plan = pfft.Descriptor(
            lengths=[n], number_of_transforms=batch,
            complex_storage=pfft.ComplexStorage.SPLIT_COMPLEX,
        ).commit()
        re = self.uniform((batch * n,))
        im = self.uniform((batch * n,))
        (yr, yi), first_s = self.first_call(plan.compute_forward, re, im)
        if not self.finite(yr, yi):
            raise AssertionError("non-finite output")
        rows = jnp.asarray(sample_rows(batch, n, self.seed))

        def host(a):
            return np.asarray(a.reshape(batch, n)[rows]).astype(np.float64)

        x_rows = host(re) + 1j * host(im)
        check = check_rows(
            host(yr) + 1j * host(yi), np.fft.fft(x_rows, axis=1), n,
            np.float32,
        )
        lib_ms = self.time_ms(plan.compute_forward, re, im)
        ref_ms = self.time_ms(
            jax.jit(
                lambda a, b: jnp.fft.fft(
                    jax.lax.complex(a, b).reshape(batch, n), axis=-1
                )
            ),
            re, im,
        )
        self.report(
            f"split-complex N={n} batch={batch}", check, lib_ms, ref_ms,
            f"  first call {first_s:.1f} s",
        )

    def functional(self, n, batch):
        import jax.numpy as jnp

        import portfft_tpu as pfft

        jax = self.jax
        z = jax.lax.complex(
            self.uniform((batch, n)), self.uniform((batch, n))
        )
        y, first_s = self.first_call(pfft.functional.fft, z)
        if not self.finite(y):
            raise AssertionError("non-finite output")
        rows = jnp.asarray(sample_rows(batch, n, self.seed))
        x_rows = np.asarray(z[rows]).astype(np.complex128)
        check = check_rows(
            np.asarray(y[rows]), np.fft.fft(x_rows, axis=1), n, np.float32
        )
        lib_ms = self.time_ms(pfft.functional.fft, z)
        ref_ms = self.time_ms(jax.jit(lambda a: jnp.fft.fft(a, axis=-1)), z)
        self.report(
            f"functional.fft N={n} batch={batch}", check, lib_ms, ref_ms,
            f"  first call {first_s:.1f} s",
        )

    def apply_grad(self, n, batch):
        """plan.apply inside a user jax.jit, with jax.grad through it.
        By Parseval, L = sum |FFT x|^2 = n·sum |x|^2, so dL/dx = 2n·x."""
        import jax.numpy as jnp

        import portfft_tpu as pfft

        jax = self.jax
        plan = pfft.Descriptor(lengths=[n], number_of_transforms=batch).commit()

        def loss_lib(xr, xi):
            yr, yi = plan.apply(xr, xi)
            return jnp.sum(yr * yr + yi * yi)

        def loss_ref(xr, xi):
            y = jnp.fft.fft(jax.lax.complex(xr, xi), axis=-1)
            return jnp.sum(jnp.real(y) ** 2 + jnp.imag(y) ** 2)

        lib = jax.jit(jax.value_and_grad(loss_lib, argnums=(0, 1)))
        ref_fn = jax.jit(jax.value_and_grad(loss_ref, argnums=(0, 1)))
        fwd = jax.jit(plan.apply)
        xr = self.uniform((batch, n))
        xi = self.uniform((batch, n))
        (val, (gr, gi)), first_s = self.first_call(lib, xr, xi)
        yr, yi = fwd(xr, xi)
        if not self.finite(gr, gi, yr, yi, val):
            raise AssertionError("non-finite output")
        rows = jnp.asarray(sample_rows(batch, n, self.seed))

        def host(a):
            return np.asarray(a[rows]).astype(np.float64)

        x_rows = host(xr) + 1j * host(xi)
        check_y = check_rows(
            host(yr) + 1j * host(yi), np.fft.fft(x_rows, axis=1), n,
            np.float32,
        )
        check_g = check_rows(
            host(gr) + 1j * host(gi), 2 * n * x_rows, n, np.float32
        )
        expect = n * float(jnp.sum(xr.astype(jnp.float32) ** 2 + xi**2))
        if not abs(float(val) - expect) <= 1e-4 * expect:
            raise AssertionError(f"loss {float(val)} != n·sum|x|^2 {expect}")
        lib_ms = self.time_ms(lib, xr, xi)
        ref_ms = self.time_ms(ref_fn, xr, xi)
        self.report(
            f"apply under jit N={n} batch={batch}", check_y,
            self.time_ms(fwd, xr, xi),
            self.time_ms(jax.jit(
                lambda a, b: jnp.fft.fft(jax.lax.complex(a, b), axis=-1)
            ), xr, xi),
        )
        self.report(
            f"grad through apply N={n} batch={batch}", check_g, lib_ms,
            ref_ms, f"  first call {first_s:.1f} s",
        )

    def fp64(self, n, batch):
        """Native float64 with jax_enable_x64 (run last: the flag changes
        JAX's default dtypes for everything after it)."""
        import jax.numpy as jnp

        import portfft_tpu as pfft

        jax = self.jax
        jax.config.update("jax_enable_x64", True)
        plan = pfft.Descriptor(
            lengths=[n], number_of_transforms=batch, precision="float64"
        ).commit()
        raw = self.uniform((2 * batch * n,), np.float64)
        y, first_s = self.first_call(plan.compute_forward, raw)
        if not self.finite(y):
            raise AssertionError("non-finite output")
        rows = sample_rows(batch, n, self.seed)
        x_rows = self._rows(raw, batch, n, rows, np.complex128)
        check = check_rows(
            self._rows(y, batch, n, rows, np.complex128),
            np.fft.fft(x_rows, axis=1), n, np.float64,
        )
        z = self.as_complex(raw, (batch, n))
        lib_ms = self.time_ms(plan.compute_forward, raw)
        ref_ms = self.time_ms(jax.jit(lambda a: jnp.fft.fft(a, axis=-1)), z)
        self.report(
            f"fp64 N={n} batch={batch}", check, lib_ms, ref_ms,
            f"  plan {plan.plans[n].describe()}  first call {first_s:.1f} s",
        )

    def precision_modes(self, n, batch):
        """The reduced matmul precisions a user can ask for with
        ``commit(matmul_precision=...)``, against the default HIGHEST.  On
        an H100 both run float32 matmuls in TF32; the phase passes when the
        check rejects each of them, so that it is proven tight enough to
        catch TF32 on the card, and prints their error and time."""
        import portfft_tpu as pfft

        desc = pfft.Descriptor(lengths=[n], number_of_transforms=batch)
        raw = self.uniform((2 * batch * n,))
        rows = sample_rows(batch, n, self.seed)
        ref = np.fft.fft(self._rows(raw, batch, n, rows), axis=1)
        highest_ms = self.time_ms(desc.commit().compute_forward, raw)
        accepted = []
        for mode in ("high", "default"):
            plan = desc.commit(matmul_precision=mode)
            y = plan.compute_forward(raw)
            if not self.finite(y):
                raise AssertionError(f"{mode!r}: non-finite output")
            check = check_rows(self._rows(y, batch, n, rows), ref, n,
                               np.float32)
            del y
            ms = self.time_ms(plan.compute_forward, raw)
            if check["ok"]:
                accepted.append(mode)
            print(
                f"[{'FAIL' if check['ok'] else 'PASS'}] matmul_precision="
                f"{mode!r} N={n} batch={batch}: "
                f"{'accepted' if check['ok'] else 'rejected'} "
                f"rel_l2={check['rel_l2']:.3g} (bound {check['l2_bound']:.3g})"
                f" elem/tol={check['elem_ratio']:.3g}  lib {ms:.3f} ms"
                f"  highest {highest_ms:.3f} ms ({ms / highest_ms:.2f}x)",
                flush=True,
            )
        if accepted:
            raise AssertionError(
                f"the check accepted matmul_precision {accepted}: it does not "
                "tell these modes from full float32"
            )

    def single_card(self) -> None:
        Ki, Mi = 1024, 1024 * 1024
        for n, batch in ((16, 8 * Mi), (256, 512 * Ki), (4096, 32 * Ki),
                         (65536, 2048)):
            self.run(f"c2c N={n}", lambda n=n, b=batch: self.c2c(
                n, b, unchunked=True))
        self.run("c2c backward", lambda: self.c2c(4096, 32 * Ki, "backward"))
        self.run("GLOBAL 2^20", lambda: self.c2c(1 << 20, 128))
        self.run("BLUESTEIN 65537", lambda: self.c2c(65537, 2048))
        self.run("REAL 8192", lambda: self.real(8192, 16 * Ki))
        self.run("multi-dim 1024^2", lambda: self.multidim((1024, 1024), 64))
        self.run("strided 65536", lambda: self.strided(65536, 512, 2))
        self.run("split 4096", lambda: self.split(4096, 32 * Ki))
        self.run("functional 4096", lambda: self.functional(4096, 32 * Ki))
        self.run("apply+grad 4096", lambda: self.apply_grad(4096, 32 * Ki))
        for n, batch in ((256, 512 * Ki), (4096, 32 * Ki), (65536, 2048)):
            self.run(f"precision N={n}", lambda n=n, b=batch:
                     self.precision_modes(n, b))
        self.run("fp64 4096", lambda: self.fp64(4096, 16 * Ki))

    # -- four-card phases ------------------------------------------------

    def four_cards(self) -> None:
        jax = self.jax
        devs = jax.devices()
        if len(devs) < 4:
            raise SystemExit(f"--four needs 4 GPUs; JAX found {len(devs)}")
        self.run("batch-parallel 4096 x 32Ki",
                 lambda: self.sharded(4096, 32 * 1024, seq=False))
        self.run("seq-sharded 2^24 x 8",
                 lambda: self.sharded(1 << 24, 8, seq=True))

    def sharded(self, n, batch, seq: bool):
        """Descriptor.commit(mesh=...) on a (dp, sp) mesh over four cards,
        against the NumPy reference and the same transform on one card."""
        import jax.numpy as jnp

        import portfft_tpu as pfft
        from portfft_tpu.parallel.mesh import make_mesh

        jax = self.jax
        devs = jax.devices()[:4]
        shape = (1, 4) if seq else (4, 1)
        mesh = make_mesh(shape, ("dp", "sp"), devices=devs)
        desc = pfft.Descriptor(lengths=[n], number_of_transforms=batch)
        kw = {"seq_axis": "sp"} if seq else {}
        plan = desc.commit(mesh=mesh, batch_axis="dp", **kw)
        sharding = plan.input_sharding()
        xr = jax.device_put(self.uniform((batch, n)), sharding)
        xi = jax.device_put(self.uniform((batch, n)), sharding)
        (yr, yi), first_s = self.first_call(plan.compute_forward, xr, xi)
        if not self.finite(yr, yi):
            raise AssertionError("non-finite output")
        shard_devs = {s.device for s in yr.addressable_shards}
        if shard_devs != set(devs):
            raise AssertionError(f"output shards on {shard_devs}")
        rows = sample_rows(batch, n, self.seed)
        if seq:
            rows = rows[: max(1, (MAX_REF_POINTS // 2) // n)]
        rows_d = jnp.asarray(rows)

        def host(a):
            return np.asarray(a[rows_d]).astype(np.float64)

        x_rows = host(xr) + 1j * host(xi)
        y_rows = host(yr) + 1j * host(yi)
        check = check_rows(y_rows, np.fft.fft(x_rows, axis=1), n, np.float32)

        # the same transform on one card
        one = desc.commit(device=devs[0])
        xr1 = jax.device_put(xr, devs[0])
        xi1 = jax.device_put(xi, devs[0])
        apply1 = jax.jit(one.apply)
        yr1, yi1 = apply1(xr1, xi1)
        y1_rows = host(yr1) + 1j * host(yi1)
        vs_one = float(
            np.linalg.norm(y_rows - y1_rows) / np.linalg.norm(y1_rows)
        )
        check_one = check_rows(y1_rows, np.fft.fft(x_rows, axis=1), n,
                               np.float32)
        if not check_one["ok"]:
            raise AssertionError(f"one-card run outside the bound {check_one}")
        del yr1, yi1
        jfft = jax.jit(
            lambda a, b: jnp.fft.fft(jax.lax.complex(a, b), axis=-1)
        )
        one_ms = self.time_ms(apply1, xr1, xi1)
        one_ref_ms = self.time_ms(jfft, xr1, xi1)
        del xr1, xi1
        lib_ms = self.time_ms(plan.compute_forward, xr, xi)
        ref_ms = self.time_ms(jfft, xr, xi)
        label = "seq-sharded" if seq else "batch-parallel"
        self.report(
            f"4-card {label} forward N={n} batch={batch}", check, lib_ms,
            ref_ms,
            f"  one card: lib {one_ms:.3f} ms, jnp.fft {one_ref_ms:.3f} ms"
            f"  rel diff vs one card {vs_one:.3g}"
            f"  shards on {len(shard_devs)} devices"
            f"  first call {first_s:.1f} s",
        )
        if seq:
            (br, bi), _ = self.first_call(plan.compute_backward, yr, yi)
            if not self.finite(br, bi):
                raise AssertionError("non-finite backward output")
            b_rows = host(br) + 1j * host(bi)
            check_b = check_rows(
                b_rows, np.fft.ifft(y_rows, axis=1) * n, n, np.float32
            )
            self.report(
                f"4-card seq-sharded backward N={n} batch={batch}", check_b,
                self.time_ms(plan.compute_backward, yr, yi),
                self.time_ms(
                    jax.jit(lambda a, b: jnp.fft.ifft(
                        jax.lax.complex(a, b), axis=-1)),
                    yr, yi,
                ),
            )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card sharded phases")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=10,
                        help="timed calls per measurement (median)")
    args = parser.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2

    from portfft_tpu.config import card_description, enable_persistent_cache

    print(card_description(), flush=True)
    cache = enable_persistent_cache()
    print(f"device_kind {devs[0].device_kind!r}, {len(devs)} device(s), "
          f"jax {jax.__version__}, compile cache {cache}", flush=True)
    smoke = Smoke(args.seed, args.iters)
    t0 = time.perf_counter()
    if args.four:
        smoke.four_cards()
    else:
        smoke.single_card()
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if smoke.failed:
        print(f"failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": 4 if args.four else 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
