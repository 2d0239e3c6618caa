"""Host tracing / logging subsystem.

Analogue of the reference's logging layer (common/logging.hpp:36-446):
* compile-time gates become import-time env flags (`PORTFFT_LOG_TRACES`,
  `PORTFFT_LOG_WARNINGS`) — same variable names as the reference's runtime
  masks (logging.hpp:36-73);
* `log_function_entry` decorator ≈ PORTFFT_LOG_FUNCTION_ENTRY;
* `trace` / `warn` ≈ PORTFFT_LOG_TRACE / PORTFFT_LOG_WARNING;
* `profiler_trace` wraps a block in a jax.profiler trace context (the
  reference's profiling story is event timestamps; here the native tool is
  the XLA profiler).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import sys
import time

logger = logging.getLogger("portfft_tpu")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[portfft_tpu] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() not in ("", "0", "false", "off")


TRACES_ENABLED = _env_flag("PORTFFT_LOG_TRACES")
WARNINGS_ENABLED = _env_flag("PORTFFT_LOG_WARNINGS") or TRACES_ENABLED

if TRACES_ENABLED:
    logger.setLevel(logging.DEBUG)
elif WARNINGS_ENABLED:
    logger.setLevel(logging.WARNING)


def trace(*parts) -> None:
    """Trace message (reference PORTFFT_LOG_TRACE, logging.hpp:441)."""
    if TRACES_ENABLED:
        logger.debug(" ".join(str(p) for p in parts))


def warn(*parts) -> None:
    """Warning (reference PORTFFT_LOG_WARNING, logging.hpp:442)."""
    if WARNINGS_ENABLED:
        logger.warning(" ".join(str(p) for p in parts))


def log_function_entry(fn):
    """Decorator: log entry + wall time of a host function
    (reference PORTFFT_LOG_FUNCTION_ENTRY, logging.hpp:436)."""

    if not TRACES_ENABLED:
        return fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        logger.debug(f"enter {fn.__qualname__}")
        try:
            return fn(*args, **kwargs)
        finally:
            logger.debug(
                f"exit  {fn.__qualname__} ({1e3 * (time.perf_counter() - t0):.2f} ms)"
            )

    return wrapper


@contextlib.contextmanager
def profiler_trace(name: str, log_dir: str | None = None):
    """Wrap a block in a jax.profiler trace (writes a TensorBoard trace when
    ``log_dir`` or $PORTFFT_PROFILE_DIR is set; otherwise a no-op timer)."""
    import jax

    log_dir = log_dir or os.environ.get("PORTFFT_PROFILE_DIR")
    t0 = time.perf_counter()
    if log_dir:
        with jax.profiler.trace(log_dir):
            with jax.profiler.TraceAnnotation(name):
                yield
    else:
        yield
    trace(f"{name}: {1e3 * (time.perf_counter() - t0):.2f} ms")
