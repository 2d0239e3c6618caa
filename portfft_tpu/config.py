"""Planner knobs, published device peaks, and the compile cache.

The analogue of the reference's compile-time CMake cache variables
(CMakeLists.txt:38-59 — PORTFFT_REGISTERS_PER_WI, PORTFFT_SUBGROUP_SIZES,
PORTFFT_VEC_LOAD_BYTES, ...).  :class:`DeviceConfig` holds the values the
planner decides levels and factor chains by; :data:`PEAKS` holds the
published rates a benchmark divides its own times by, keyed by the exact
``device_kind`` JAX reports.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Planner knobs: the sizes at which levels and factor chains change.

    The defaults give the factor chains the library was first tuned with
    (tests/test_config.py pins the chains of the benchmark sizes).
    Retuning them for a device is a measured change of its own."""

    #: Largest DFT factor contracted by one matmul stage of a chain.
    max_factor: int = 128
    #: Sizes at or below this are planned as ONE direct DFT matmul
    #: (level DIRECT), regardless of primality.
    direct_threshold: int = 512
    #: Second factor of the two-stage FUSED chain [n / w, w]; it also
    #: sets the single-pass cap ``2·max_factor·w`` above which Bluestein
    #: may pick a 9·2^k convolution length.
    two_stage_width: int = 128
    #: Rows per batch tile assumed when the planner sizes a FUSED chain's
    #: working set.
    fused_rows: int = 8
    #: A chain whose working set (planner.fused_working_set_bytes) stays
    #: within this many bytes is planned FUSED; larger sizes go GLOBAL.
    fused_budget_bytes: int = 9227468
    #: Bound on the first pass of a GLOBAL split G1 = a·w with G2 DIRECT
    #: (planner._global_split, preference 2).
    global_pass_budget_bytes: int = 12 << 20
    #: Working-set budget per executed batch chunk; bigger batches run
    #: under ``lax.map`` over batch chunks (the analogue of the
    #: reference's L2-resident chunking, committed_descriptor_impl.hpp:605).
    #: The working set is estimated as 16 bytes of intermediates per
    #: scalar of the widest plan level, so 2 GiB bounds a chunk's
    #: temporaries to a few GiB on any card.  On an H100 the benchmark's
    #: headline sizes ran 12-22 % faster unchunked (PERF.md); raising the
    #: budget is a measured change of its own, with peak memory beside it.
    hbm_chunk_bytes: int = 2 << 30


def resolve_device_config(device=None) -> DeviceConfig:
    """The planner knobs for ``device``: a :class:`DeviceConfig` passes
    through unchanged; any device plans with the defaults."""
    if isinstance(device, DeviceConfig):
        return device
    return DeviceConfig()


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one device (dense, no sparsity)."""

    #: Device memory bandwidth, GB/s.
    hbm_gbps: float
    #: Device memory, GB.
    memory_gb: float
    #: float32 outside the tensor cores, TFLOP/s.
    fp32_tflops: float
    #: TF32 on the tensor cores, TFLOP/s.
    tf32_tflops: float
    #: bf16 on the tensor cores, TFLOP/s.
    bf16_tflops: float
    #: float64 on the tensor cores, TFLOP/s.
    fp64_tflops: float
    #: Where the numbers come from.
    source: str


#: Keyed by the exact ``device_kind`` string JAX reports.
PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        hbm_gbps=3350.0,
        memory_gb=80.0,
        fp32_tflops=67.0,
        tf32_tflops=495.0,
        bf16_tflops=989.0,
        fp64_tflops=67.0,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5, 700 W",
    ),
}


def device_peaks(device=None) -> DevicePeaks:
    """Published peaks of ``device`` (default: the first JAX device).

    Raises LookupError for a device whose ``device_kind`` the table does
    not hold, and for the CPU, which has no published peak: a rate is
    never divided by an assumed one."""
    if device is None:
        import jax

        device = jax.devices()[0]
    if device.platform == "cpu":
        raise LookupError("the CPU backend has no published peak")
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise LookupError(
            f"no published peaks for device_kind {device.device_kind!r}; "
            "add them to portfft_tpu.config.PEAKS with their source"
        ) from None


def card_description() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``), one line per card."""
    try:
        res = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=60,
            check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return res.stdout.strip()


#: Compile-cache directory used when JAX_COMPILATION_CACHE_DIR is unset: a
#: fixed path inside the checkout (listed in .gitignore), so a later
#: process in the same checkout finds what an earlier one compiled.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir() -> str:
    """Where :func:`enable_persistent_cache` keeps compiled executables."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Persist compiled executables across processes (the framework's
    plan-reuse story, replacing the reference's in-memory kernel-bundle
    sharing, committed_descriptor_impl.hpp:774-803: identical descriptors
    re-committed in a new process hit the XLA compilation cache instead of
    recompiling).  Honours JAX_COMPILATION_CACHE_DIR, which JAX reads
    itself; otherwise sets :data:`DEFAULT_CACHE_DIR`.  Returns the
    directory in use."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
