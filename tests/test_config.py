"""Planner knobs, published device peaks, the compile-cache rule, and the
golden factor chains of the benchmark sizes."""

import dataclasses
import os
import pathlib

import jax
import pytest

from portfft_tpu import config
from portfft_tpu.config import DeviceConfig
from portfft_tpu.planner import plan_1d

REPO = pathlib.Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class FakeDevice:
    platform: str
    device_kind: str


def test_h100_resolves_to_published_peaks():
    peaks = config.device_peaks(FakeDevice("gpu", "NVIDIA H100 80GB HBM3"))
    assert peaks.hbm_gbps == 3350.0
    assert peaks.memory_gb == 80.0
    assert (peaks.fp32_tflops, peaks.tf32_tflops, peaks.bf16_tflops) == (
        67.0, 495.0, 989.0,
    )
    assert peaks.fp64_tflops == 67.0
    assert "data sheet" in peaks.source


@pytest.mark.parametrize(
    "kind", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "h100", ""]
)
def test_unknown_gpu_kind_raises(kind):
    with pytest.raises(LookupError, match="no published peaks"):
        config.device_peaks(FakeDevice("gpu", kind))


def test_cpu_has_no_peak():
    with pytest.raises(LookupError, match="CPU"):
        config.device_peaks(FakeDevice("cpu", "cpu"))
    with pytest.raises(LookupError):
        config.device_peaks()  # the test process runs on the CPU


def test_device_config_is_device_independent():
    assert config.resolve_device_config() == DeviceConfig()
    assert config.resolve_device_config(jax.devices()[0]) == DeviceConfig()
    custom = DeviceConfig(hbm_chunk_bytes=1 << 20)
    assert config.resolve_device_config(custom) is custom


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compile_cache_dir() == str(tmp_path)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append(k))
    assert config.enable_persistent_cache() == str(tmp_path)
    # JAX reads the variable itself: no other directory is set in code
    assert "jax_compilation_cache_dir" not in calls


def test_compile_cache_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = pathlib.Path(config.compile_cache_dir())
    assert path == REPO / ".jax_cache"
    assert config.compile_cache_dir() == str(path)  # fixed, not per call
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
    updates = {}
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: updates.__setitem__(k, v)
    )
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    assert config.enable_persistent_cache() == str(path)
    assert updates["jax_compilation_cache_dir"] == str(path)


def test_card_description_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert config.card_description().startswith("nvidia-smi unavailable")


# Factor chains of the benchmark and smoke sizes.  The planner knobs were
# renamed from the first target's terms with their values kept; these pin
# the plans so that a change of chain is a deliberate, measured change.
GOLDEN = [
    (16, 4, "direct(n=16, factors=[16])"),
    (32, 4, "direct(n=32, factors=[32])"),
    (256, 4, "direct(n=256, factors=[256])"),
    (512, 4, "direct(n=512, factors=[512])"),
    (1024, 4, "fused(n=1024, factors=[8, 128])"),
    (4096, 4, "fused(n=4096, factors=[32, 128])"),
    (4096, 8, "fused(n=4096, factors=[32, 128])"),
    (8192, 4, "fused(n=8192, factors=[64, 128])"),
    (65536, 4, "global(direct(n=256, factors=[256]) x "
               "direct(n=256, factors=[256]))"),
    (1 << 17, 4, "global(direct(n=512, factors=[512]) x "
                 "direct(n=256, factors=[256]))"),
    (1 << 18, 4, "global(direct(n=512, factors=[512]) x "
                 "direct(n=512, factors=[512]))"),
    (1 << 19, 4, "global(fused(n=2048, factors=[16, 128]) x "
                 "direct(n=256, factors=[256]))"),
    (1 << 20, 4, "global(fused(n=2048, factors=[16, 128]) x "
                 "direct(n=512, factors=[512]))"),
    (1 << 20, 8, "global(fused(n=1024, factors=[8, 128]) x "
                 "fused(n=1024, factors=[8, 128]))"),
    (1 << 24, 4, "global(fused(n=4096, factors=[32, 128]) x "
                 "fused(n=4096, factors=[32, 128]))"),
    (65537, 4, "bluestein(n=65537, conv=global(direct(n=384, factors=[384])"
               " x direct(n=384, factors=[384])))"),
    (65537, 8, "bluestein(n=65537, conv=global(direct(n=384, factors=[384])"
               " x direct(n=384, factors=[384])))"),
    (4099, 4, "bluestein(n=4099, conv=fused(n=12288, factors=[96, 128]))"),
    (6000, 4, "fused(n=6000, factors=[125, 48])"),
    (15015, 4, "fused(n=15015, factors=[105, 13, 11])"),
    (15015, 8, "global(direct(n=143, factors=[143]) x "
               "direct(n=105, factors=[105]))"),
    (9800 * 16, 4, "global(direct(n=400, factors=[400]) x "
                   "direct(n=392, factors=[392]))"),
]


@pytest.mark.parametrize("n,itemsize,expected", GOLDEN)
def test_golden_plans(n, itemsize, expected):
    assert plan_1d(n, DeviceConfig(), itemsize).describe() == expected
