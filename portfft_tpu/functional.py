"""``numpy.fft``-style functional convenience API over the descriptor path.

JAX users expect ``fft(x, axis=-1)``, not a plan-and-execute object model;
these wrappers commit (and LRU-cache) the matching :class:`Descriptor` per
(shape, dtype, norm) and dispatch through the library's compute entry
points.  A thin extension layer:
everything here is expressible with the core API (the reference exposes
only the descriptor model, committed_descriptor.hpp:58-310).

For embedding a transform inside your own ``jax.jit`` / ``lax.scan`` /
``jax.grad`` program, commit a plan once and use
:meth:`CommittedDescriptor.apply` instead — these wrappers call the
cached plan's ``compute_*`` entry, which manages its own jit.

Normalization (``norm``) follows numpy: ``None``/"backward" = forward
unscaled + inverse 1/n, "ortho" = 1/sqrt(n) both ways, "forward" = 1/n on
the forward transform.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np

from .descriptor import Descriptor
from .enums import Domain
from .exceptions import InvalidConfiguration

_NORMS = ("backward", "ortho", "forward")


def _canon_norm(norm: str | None) -> str:
    """None and "backward" are the same mode — canonicalize before the
    plan-cache key so they share one committed plan."""
    norm = norm or "backward"
    if norm not in _NORMS:
        raise InvalidConfiguration(f"norm must be one of {_NORMS}")
    return norm


def _scales(n: int, norm: str):
    if norm == "backward":
        return 1.0, 1.0 / n
    if norm == "ortho":
        s = 1.0 / math.sqrt(n)
        return s, s
    return 1.0 / n, 1.0


@functools.lru_cache(maxsize=128)
def _plan(lengths: tuple, batch: int, precision: str, domain: Domain,
          norm: str):
    n = math.prod(lengths)
    fs, bs = _scales(n, norm)
    return Descriptor(
        lengths=list(lengths),
        number_of_transforms=batch,
        precision=precision,
        domain=domain,
        forward_scale=fs,
        backward_scale=bs,
    ).commit()


def clear_plan_cache() -> None:
    """Drop every cached committed plan (frees their device tables)."""
    _plan.cache_clear()


def _precision_of(dtype) -> str:
    dt = np.dtype(dtype)
    if dt in (np.complex128, np.float64):
        return "float64"
    return "float32"


def _to_last(x, axis: int):
    """Move ``axis`` to the end (no-op for the default -1)."""
    if axis in (-1, x.ndim - 1):
        return x, False
    return jnp.moveaxis(x, axis, -1), True


def _sized(x, n: int | None):
    """numpy fft's ``n=``: truncate or zero-pad the last axis to n."""
    if n is None or n == x.shape[-1]:
        return x
    if n < x.shape[-1]:
        return x[..., :n]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
    return jnp.pad(x, pad)


def _c2c(x, k: int, forward: bool, norm):
    x = jnp.asarray(x)
    if x.ndim < k:
        raise InvalidConfiguration(
            f"input has {x.ndim} dims; transform needs {k}"
        )
    lengths = tuple(int(s) for s in x.shape[-k:])
    lead = x.shape[:-k]
    batch = int(np.prod(lead, dtype=np.int64)) if lead else 1
    plan = _plan(lengths, batch, _precision_of(x.dtype), Domain.COMPLEX,
                 _canon_norm(norm))
    cdt = jnp.complex128 if _precision_of(x.dtype) == "float64" else (
        jnp.complex64
    )
    flat = x.astype(cdt).reshape(-1)
    run = plan.compute_forward if forward else plan.compute_backward
    return run(flat).reshape(*lead, *lengths)


def fft(x, n=None, axis=-1, *, norm=None):
    """1D forward DFT (numpy signature: ``n`` pads/truncates, ``axis``
    selects the transform axis; batched over the other axes)."""
    x, moved = _to_last(jnp.asarray(x), axis)
    y = _c2c(_sized(x, n), 1, True, norm)
    return jnp.moveaxis(y, -1, axis) if moved else y


def ifft(x, n=None, axis=-1, *, norm=None):
    """1D inverse DFT (numpy normalization)."""
    x, moved = _to_last(jnp.asarray(x), axis)
    y = _c2c(_sized(x, n), 1, False, norm)
    return jnp.moveaxis(y, -1, axis) if moved else y


def fft2(x, *, norm=None):
    """2D forward DFT over the last two axes."""
    return _c2c(x, 2, True, norm)


def ifft2(x, *, norm=None):
    return _c2c(x, 2, False, norm)


def fftn(x, *, ndim: int | None = None, norm=None):
    """N-D forward DFT over the last ``ndim`` axes (default: all)."""
    return _c2c(x, ndim or jnp.asarray(x).ndim, True, norm)


def ifftn(x, *, ndim: int | None = None, norm=None):
    return _c2c(x, ndim or jnp.asarray(x).ndim, False, norm)


def _herm_full(x, lengths):
    """Rebuild the full complex spectrum from a half spectrum over the
    last ``len(lengths)`` transform axes (Hermitian symmetry:
    full[k] = conj(x[-k mod N]) elementwise over the transform axes)."""
    k = len(lengths)
    n = lengths[-1]
    h1 = n // 2 + 1
    # tail bins j = h1..n-1 read x[..., n-j] = flip of bins 1..n-h1
    t = jnp.flip(x[..., 1:n - h1 + 1], axis=-1)
    for a in range(x.ndim - k, x.ndim - 1):
        t = jnp.roll(jnp.flip(t, axis=a), 1, axis=a)
    return jnp.concatenate([x, jnp.conj(t)], axis=-1)


def rfft(x, n=None, axis=-1, *, norm=None):
    """1D real-to-complex DFT -> (..., n//2+1) along ``axis``."""
    x, moved = _to_last(jnp.asarray(x), axis)
    x = _sized(x, n)
    n = int(x.shape[-1])
    if n % 2:
        # the committed REAL path requires an even length; odd sizes run
        # the C2C plan and keep the non-redundant half (numpy semantics)
        y = _c2c(x.astype(jnp.complex64 if _precision_of(x.dtype)
                          == "float32" else jnp.complex128), 1, True,
                 norm)[..., :n // 2 + 1]
        return jnp.moveaxis(y, -1, axis) if moved else y
    lead = x.shape[:-1]
    batch = int(np.prod(lead, dtype=np.int64)) if lead else 1
    plan = _plan((n,), batch, _precision_of(x.dtype), Domain.REAL,
                 _canon_norm(norm))
    y = plan.compute_forward(x.reshape(-1))
    y = _repair(plan, y).reshape(*lead, n // 2 + 1)
    return jnp.moveaxis(y, -1, axis) if moved else y


def _repair(plan, y):
    """Re-pair a raw interleaved float spectrum (jax-input convention)
    into complex through the layout-safe helper."""
    if jnp.iscomplexobj(y):
        return y
    import jax as _jax

    re, im = plan._deinterleave(y)
    return _jax.lax.complex(re, im)


def rfftn(x, *, ndim: int | None = None, norm=None):
    """N-D real-to-complex DFT over the last ``ndim`` axes (default all):
    R2C on the last axis (-> n//2+1 bins), C2C on the others — numpy
    rfftn semantics."""
    x = jnp.asarray(x)
    k = ndim or x.ndim
    lengths = tuple(int(s) for s in x.shape[-k:])
    if lengths[-1] % 2:
        cdt = (jnp.complex128 if _precision_of(x.dtype) == "float64"
               else jnp.complex64)
        return _c2c(x.astype(cdt), k, True, norm)[
            ..., :lengths[-1] // 2 + 1]
    lead = x.shape[:-k]
    batch = int(np.prod(lead, dtype=np.int64)) if lead else 1
    plan = _plan(lengths, batch, _precision_of(x.dtype), Domain.REAL,
                 _canon_norm(norm))
    y = _repair(plan, plan.compute_forward(x.reshape(-1)))
    return y.reshape(*lead, *lengths[:-1], lengths[-1] // 2 + 1)


def rfft2(x, *, norm=None):
    """2D real-to-complex DFT over the last two axes."""
    return rfftn(x, ndim=2, norm=norm)


def irfftn(x, s=None, *, norm=None):
    """N-D inverse of :func:`rfftn`; ``s`` is the full output lengths.
    Like numpy, ``s=None`` assumes an even last axis = 2*(bins-1)."""
    x = jnp.asarray(x)
    if s is None:
        s = (*x.shape[:-1], 2 * (int(x.shape[-1]) - 1))
    lengths = tuple(int(v) for v in s)
    k = len(lengths)
    h1 = lengths[-1] // 2 + 1
    if tuple(x.shape[-k:]) != (*lengths[:-1], h1):
        raise InvalidConfiguration(
            f"half spectrum shape {x.shape[-k:]} does not match s={s} "
            f"(expected {(*lengths[:-1], h1)})"
        )
    if lengths[-1] % 2:
        return jnp.real(_c2c(_herm_full(x, lengths), k, False, norm))
    lead = x.shape[:-k]
    batch = int(np.prod(lead, dtype=np.int64)) if lead else 1
    plan = _plan(lengths, batch, _precision_of(x.dtype), Domain.REAL,
                 _canon_norm(norm))
    y = plan.compute_backward(x.reshape(-1))
    return y.reshape(*lead, *lengths)


def irfft2(x, s=None, *, norm=None):
    return irfftn(x, s, norm=norm)


def irfft(x, n: int | None = None, axis=-1, *, norm=None):
    """1D complex-to-real inverse of :func:`rfft`; ``n`` is the output
    length.  Like numpy, ``n=None`` assumes even output = 2*(bins-1)."""
    x, moved = _to_last(jnp.asarray(x), axis)
    h1 = int(x.shape[-1])
    if n is None:
        n = 2 * (h1 - 1)
    if h1 != n // 2 + 1:
        raise InvalidConfiguration(
            f"half spectrum has {h1} bins; expected {n // 2 + 1} for n={n}"
        )
    if n % 2:
        y = jnp.real(_c2c(_herm_full(x, (n,)), 1, False, norm))
        return jnp.moveaxis(y, -1, axis) if moved else y
    lead = x.shape[:-1]
    batch = int(np.prod(lead, dtype=np.int64)) if lead else 1
    plan = _plan((n,), batch, _precision_of(x.dtype), Domain.REAL,
                 _canon_norm(norm))
    y = plan.compute_backward(x.reshape(-1))
    y = y.reshape(*lead, n)
    return jnp.moveaxis(y, -1, axis) if moved else y


def hfft(x, n: int | None = None, axis=-1, *, norm=None):
    """DFT of a signal with Hermitian symmetry (real spectrum), numpy
    semantics: ``hfft(a, n) == irfft(conj(a), n) * n`` modulo norm.
    Implemented through the C2R path (the committed plans never see a
    redundant full spectrum)."""
    x, moved = _to_last(jnp.asarray(x), axis)
    h1 = int(x.shape[-1])
    if n is None:
        n = 2 * (h1 - 1)
    # hfft's norm conventions mirror the *forward* family: backward =
    # unscaled, ortho = 1/sqrt(n), forward = 1/n.  irfft applies the
    # inverse-family scale, so run it un-normalized and scale explicitly.
    y = irfft(jnp.conj(x), n, norm=None) * n
    canon = _canon_norm(norm)
    if canon == "ortho":
        y = y / math.sqrt(n)
    elif canon == "forward":
        y = y / n
    return jnp.moveaxis(y, -1, axis) if moved else y


def ihfft(x, n: int | None = None, axis=-1, *, norm=None):
    """Inverse of :func:`hfft` (real input -> half spectrum), numpy
    semantics: ``ihfft(a, n) == conj(rfft(a, n)) / n`` modulo norm."""
    x, moved = _to_last(jnp.asarray(x), axis)
    x = _sized(x, n)
    n = int(x.shape[-1])
    y = jnp.conj(rfft(x, norm=None)) / n
    canon = _canon_norm(norm)
    if canon == "ortho":
        y = y * math.sqrt(n)
    elif canon == "forward":
        y = y * n
    return jnp.moveaxis(y, -1, axis) if moved else y


def fftfreq(n: int, d: float = 1.0, *, dtype=None):
    """Sample frequencies for :func:`fft` output (numpy layout:
    [0, 1, ..., n//2-1, -n//2, ..., -1] / (d*n))."""
    dtype = dtype or jnp.float32
    k = jnp.arange(n, dtype=dtype)
    k = jnp.where(k >= (n + 1) // 2, k - n, k)
    return k / (n * d)


def rfftfreq(n: int, d: float = 1.0, *, dtype=None):
    """Sample frequencies for :func:`rfft` output ([0..n//2] / (d*n))."""
    dtype = dtype or jnp.float32
    return jnp.arange(n // 2 + 1, dtype=dtype) / (n * d)


def _shift_axes(x, axes):
    if axes is None:
        return tuple(range(x.ndim))
    if isinstance(axes, int):
        return (axes,)
    return tuple(axes)


def fftshift(x, axes=None):
    """Move the zero-frequency bin to the center (numpy fftshift)."""
    x = jnp.asarray(x)
    ax = _shift_axes(x, axes)
    return jnp.roll(x, [x.shape[a] // 2 for a in ax], ax)


def ifftshift(x, axes=None):
    """Inverse of :func:`fftshift` (exact for odd lengths too)."""
    x = jnp.asarray(x)
    ax = _shift_axes(x, axes)
    return jnp.roll(x, [-(x.shape[a] // 2) for a in ax], ax)
