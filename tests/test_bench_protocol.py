"""The bench driver's round-robin group protocol (bench.bench_group).

The bench interleaves timing bursts across a group's configs instead of
giving each config one contiguous window (reference protocol:
launch_bench.hpp:50-145 measures contiguously — the interleave keeps slow
drift of a shared card from landing on one config; the per-config min over
rounds keeps the metric).  These run the protocol on the CPU with a
stand-in bandwidth of 3350 GB/s; the numbers mean nothing, the control
flow does.
"""

import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench


def test_bench_group_round_robin_results():
    configs = [("tiny16", 16, 8), ("tiny64", 64, 4)]
    results = bench.bench_group(configs, 3350.0)
    assert set(results) == {"tiny16", "tiny64"}
    for r in results.values():
        assert r["gflops"] > 0 and 0 < r["eff"] < 1
        assert r["gbps"] > 0 and r["ms"] > 0


def test_bench_group_samples_interleaved(monkeypatch):
    order = []
    real_sample = bench.sample_config

    def spy(st):
        order.append(st["name"])
        real_sample(st)

    monkeypatch.setattr(bench, "sample_config", spy)
    bench.bench_group([("a16", 16, 4), ("b32", 32, 4)], 3350.0)
    # rounds alternate configs: a, b, a, b, ... never a,a,a..b,b,b
    assert order[: 2 * bench.SAMPLES] == ["a16", "b32"] * bench.SAMPLES


def test_bench_group_rotate_falls_back_to_singleton_groups(monkeypatch):
    prepared = []
    real_prepare = bench.prepare_config

    def spy(name, n, batch, rotate=0):
        prepared.append((name, rotate))
        return real_prepare(name, n, batch, rotate)

    monkeypatch.setattr(bench, "prepare_config", spy)
    results = bench.bench_group(
        [("a16", 16, 4), ("b32", 32, 4)], 3350.0, rotate=2
    )
    assert set(results) == {"a16", "b32"}
    assert prepared == [("a16", 2), ("b32", 2)]


def test_bench_extra_round_robin(monkeypatch, capsys):
    monkeypatch.setattr(
        bench, "EXTRA_CONFIGS",
        [("backward_tiny", 64, 4), ("strided_tiny", 64, 4)],
    )
    monkeypatch.setattr(bench, "REAL_CONFIGS", [("real_tiny", 32, 4)])
    monkeypatch.setattr(bench, "MULTIDIM_CONFIGS", [("md_8x16", [8, 16], 2)])
    monkeypatch.setattr(bench, "RUNS_TO_AVERAGE", 2)

    recorded = bench.bench_extra()
    err = capsys.readouterr().err
    for name in ("backward_tiny", "strided_tiny", "real_tiny", "md_8x16"):
        assert name in err, err
        # every extra-set config lands in the JSON line
        assert recorded[name]["ms"] > 0 and recorded[name]["gflops"] >= 0
    assert "FAILED" not in err, err


def test_bench_group_survives_failing_config(monkeypatch):
    real_prepare = bench.prepare_config

    def boom(name, n, batch, rotate=0):
        if name == "bad":
            raise RuntimeError("no plan")
        return real_prepare(name, n, batch, rotate)

    monkeypatch.setattr(bench, "prepare_config", boom)
    results = bench.bench_group([("bad", 7, 3), ("a16", 16, 4)], 3350.0)
    assert set(results) == {"a16"}


def test_bench_refuses_cpu():
    """main() measures a GPU only: on the CPU it exits non-zero before
    timing anything."""
    res = subprocess.run(
        [sys.executable, str(Path(bench.__file__))],
        capture_output=True,
        text=True,
        timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
        cwd=str(Path(bench.__file__).parent),
    )
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "GPU" in res.stderr
