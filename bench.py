#!/usr/bin/env python
"""Benchmark driver — portFFT's headline configurations on one GPU.

Mirrors the reference benchmark set and metrics
(test/bench/portfft/bench_float.cpp:49-52, test/bench/utils/
reference_dft_set.hpp:89-92 and ops_estimate.hpp:34-50):

* configs: C2C fp32 forward out-of-place
    N=16    batch=8Mi    (reference workitem level  / DIRECT here)
    N=256   batch=512Ki  (subgroup                  / DIRECT)
    N=4096  batch=32Ki   (workgroup                 / FUSED)
    N=65536 batch=2048   (global                    / GLOBAL)
* flops counter:      5·batch·N·log2(N) / s   (radix-2 CT estimate)
* throughput counter: batch·(bytes_in+bytes_out) / s  (single-pass bytes)

Protocol follows the reference host-time measurement (launch_bench.hpp:
50-145): warm-up + verification on the first run, then the average of
``RUNS_TO_AVERAGE`` asynchronously-dispatched computes per sample, ended
by ``block_until_ready``.  Samples are interleaved round-robin across the
configs of a group (SAMPLES rounds, per-config min).

The default run also reports the GLOBAL-level ladder N=2^17..2^20 on
stderr, and the extended sets (backward, Bluestein prime, strided, REAL,
multi-dim, emulated fp64).

Run it on the card, one process for the card: ``python bench.py``.  It
exits non-zero when JAX finds no GPU.  Prints ONE JSON line: the headline
metric is the geometric-mean GFLOP/s across the four configs, with the
geometric-mean share of the card's published memory bandwidth
(portfft_tpu.config.PEAKS) beside it.
"""

import json
import math
import sys
import time

import numpy as np

CONFIGS = [
    ("small_1d", 16, 8 * 1024 * 1024),
    ("medium_small_1d", 256, 512 * 1024),
    ("medium_large_1d", 4096, 32 * 1024),
    ("large_1d", 65536, 2048),
]
# GLOBAL-level ladder N=2^17..2^20 (four-step plans).
LADDER_CONFIGS = [
    ("ladder_2^17", 1 << 17, 1024),
    ("ladder_2^18", 1 << 18, 512),
    ("ladder_2^19", 1 << 19, 256),
    ("ladder_2^20", 1 << 20, 128),
]
# The reference lists these as planned-but-unwired sets
# (reference_dft_set.hpp:43-47,93,104-113); we run them with --set full.
EXTRA_CONFIGS = [
    ("large_1d_prime", 65537, 2048),     # Bluestein (reference: planned)
    ("backward_medium", 4096, 32 * 1024),  # direction=backward
    # UNPACKED stride-2 input at GLOBAL size: exercises the regular-
    # rectangle gather (committed._regular_1d)
    ("strided_large", 65536, 512),
]
MULTIDIM_CONFIGS = [
    ("md_512x512", [512, 512], 256),
    ("md_1024x1024", [1024, 1024], 64),
    ("md_128^3", [128, 128, 128], 32),
]
REAL_CONFIGS = [  # real-domain set (reference planned N set:
    # {32, 512, 8192, 131072}, reference_dft_set.hpp:104-113)
    ("real_small", 32, 2 * 1024 * 1024),
    ("real_medium", 512, 256 * 1024),
    ("real_large", 8192, 16 * 1024),
    ("real_131072", 131072, 1024),
]
DF64_CONFIGS = [  # emulated-fp64 cost record
    ("df64_4096", 4096, 512),
]
RUNS_TO_AVERAGE = 10
SAMPLES = 5


def prepare_config(name, n, batch, rotate=0):
    """Commit + verify one config; returns the timing state (device buffers
    stay resident so samples can interleave across configs)."""
    import jax.numpy as jnp

    import portfft_tpu as pfft

    desc = pfft.Descriptor(lengths=[n], number_of_transforms=batch)
    plan = desc.commit()
    print(f"  {name}: {plan.plans[n].describe()}", file=sys.stderr)

    rng = np.random.default_rng(0)
    # Raw interleaved float buffer — the zero-conversion device path.
    x = rng.uniform(-1, 1, 2 * batch * n).astype(np.float32)
    xd = jnp.asarray(x)
    # --rotate: cycle distinct input buffers between iterations, the
    # reference's cache-defeat protocol (bench_utils.hpp:39-64, ≤10
    # rotating buffers).
    inputs = [xd]
    for i in range(1, rotate):
        inputs.append(
            jnp.asarray(rng.uniform(-1, 1, 2 * batch * n).astype(np.float32))
        )

    # First run verifies against the oracle on a slice (reference
    # PORTFFT_VERIFY_BENCHMARKS, launch_bench.hpp:94-102).
    y = plan.compute_forward(xd)
    check_b = min(batch, 4)
    got = np.asarray(y[: 2 * check_b * n]).view(np.complex64).reshape(check_b, n)
    ref = np.fft.fft(
        x[: 2 * check_b * n].view(np.complex64).reshape(check_b, n), axis=1
    )
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    if not rel < 1e-2:
        raise AssertionError(f"{name}: verification failed, rel={rel}")
    return {
        "name": name, "n": n, "batch": batch,
        "compute": plan.compute_forward,
        "inputs": inputs, "y": y, "rel": rel, "times": [],
    }


def sample_config(st):
    """One timing burst for a prepared config: RUNS_TO_AVERAGE
    asynchronously-dispatched computes ended by ``block_until_ready``;
    records the mean time per call."""
    import jax

    compute, inputs = st["compute"], st["inputs"]
    jax.block_until_ready(st["y"])
    t0 = time.perf_counter()
    for it in range(RUNS_TO_AVERAGE):
        y = compute(inputs[it % len(inputs)])
    jax.block_until_ready(y)
    st["times"].append((time.perf_counter() - t0) / RUNS_TO_AVERAGE)
    st["y"] = y


def sample_states(states, samples, on_round=None):
    """``samples`` interleaved rounds of sample_config over ``states``;
    failures mark the state and drop it.  Returns the surviving states."""
    for _ in range(samples):
        if on_round is not None:
            on_round()
        for st in states:
            if st.get("failed"):
                continue
            try:
                sample_config(st)
            except Exception as exc:
                print(f"  {st['name']}: FAILED {exc}", file=sys.stderr)
                st["failed"] = True
    return [st for st in states if not st.get("failed") and st["times"]]


def report_config(st, hbm_gbps):
    n, batch = st["n"], st["batch"]
    t = min(st["times"])
    flops = 5.0 * batch * n * math.log2(n)
    bytes_moved = batch * n * 8 * 2  # complex64 in + out, single-pass
    gflops = flops / t / 1e9
    gbps = bytes_moved / t / 1e9
    eff = gbps / hbm_gbps
    print(
        f"  {st['name']:18s} N={n:<7d} b={batch:<9d} {t*1e3:8.3f} ms  "
        f"{gflops:9.1f} GFLOP/s  {gbps:8.1f} GB/s  {100*eff:5.1f}% of peak "
        f"bandwidth  rel_err={st['rel']:.1e}",
        file=sys.stderr,
    )
    return {"gflops": gflops, "eff": eff, "gbps": gbps, "ms": t * 1e3}


GROUP_BUDGET_BYTES = 7 << 30  # resident buffers per round-robin group


def _chunk_by_budget(configs, rotate):
    """Split configs into groups whose resident device bytes (inputs +
    output + engine intermediates, ~3 buffers per config, more with
    --rotate) fit GROUP_BUDGET_BYTES, preserving order."""
    groups, cur, cur_bytes = [], [], 0
    for item in configs:
        n, batch = item[1], item[2]
        est = 2 * batch * n * 4 * (max(1, rotate) + 2)
        if cur and cur_bytes + est > GROUP_BUDGET_BYTES:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(item)
        cur_bytes += est
    if cur:
        groups.append(cur)
    return groups


def bench_group(configs, hbm_gbps, rotate=0):
    """Bench configs with timing bursts interleaved round-robin within
    groups sized to GROUP_BUDGET_BYTES (SAMPLES rounds, per-config min).
    A group's buffers stay device-resident; --rotate multiplies the input
    buffers and shrinks groups accordingly.

    Returns results mapping name -> report_config's dict."""
    results = {}
    for group in _chunk_by_budget(configs, rotate):
        states = []
        for name, n, batch in group:
            try:
                states.append(prepare_config(name, n, batch, rotate))
            except Exception as exc:
                print(f"  {name}: FAILED {exc}", file=sys.stderr)
        for st in sample_states(states, SAMPLES):
            results[st["name"]] = report_config(st, hbm_gbps)
    return results


def bench_extra():
    """Extended sets: backward, Bluestein prime, strided, real-domain,
    multi-dim (the reference's planned sets, reference_dft_set.hpp:37-113).
    Each set is prepared up front and timed round-robin.  Returns a dict
    name -> {ms, gflops} recorded in the JSON line."""
    import jax.numpy as jnp

    import portfft_tpu as pfft
    from portfft_tpu import Domain

    rng = np.random.default_rng(0)
    recorded = {}

    def run_set(prepare, configs):
        states = []
        for item in configs:
            name = item[0]
            try:
                states.append(prepare(*item))
            except Exception as e:
                print(f"  {name}: FAILED {e}", file=sys.stderr)
        for st in sample_states(states, samples=3):
            t = min(st["times"])
            print(
                f"  {st['name']:18s} {st['label']:12s} {t*1e3:8.3f} ms "
                f"{st['flops']/t/1e9:9.1f} GFLOP/s" + st["tail"](t),
                file=sys.stderr,
            )
            recorded[st["name"]] = {
                "ms": round(t * 1e3, 3),
                "gflops": round(st["flops"] / t / 1e9, 1),
            }

    def prep_extra(name, n, batch):
        if "strided" in name:
            desc = pfft.Descriptor(
                lengths=[n],
                number_of_transforms=batch,
                forward_strides=[2],
                forward_distance=2 * n,
                backward_strides=[1],
                backward_distance=n,
            )
            count = 2 * batch * 2 * n
        else:
            desc = pfft.Descriptor(lengths=[n], number_of_transforms=batch)
            count = 2 * batch * n
        plan = desc.commit()
        x = jnp.asarray(rng.uniform(-1, 1, count).astype(np.float32))
        compute = (
            plan.compute_backward if "backward" in name
            else plan.compute_forward
        )
        return {
            "name": name, "label": f"N={n}", "compute": compute, "inputs": [x],
            "y": compute(x), "times": [],
            "flops": 5 * batch * n * math.log2(n), "tail": lambda t: "",
        }

    def prep_real(name, n, batch):
        desc = pfft.Descriptor(
            lengths=[n], number_of_transforms=batch, domain=Domain.REAL
        )
        plan = desc.commit()
        x = jnp.asarray(rng.uniform(-1, 1, batch * n).astype(np.float32))
        return {
            "name": name, "label": f"N={n}", "compute": plan.compute_forward,
            "inputs": [x], "y": plan.compute_forward(x), "times": [],
            "flops": 2.5 * batch * n * math.log2(n), "tail": lambda t: "",
        }

    def prep_md(name, lengths, batch):
        desc = pfft.Descriptor(
            lengths=list(lengths), number_of_transforms=batch
        )
        plan = desc.commit()
        n = math.prod(lengths)
        x = jnp.asarray(rng.uniform(-1, 1, 2 * batch * n).astype(np.float32))
        y = plan.compute_forward(x)
        check_b = min(batch, 2)
        got = (
            np.asarray(y[: 2 * check_b * n])
            .view(np.complex64)
            .reshape(check_b, *lengths)
        )
        ref = np.fft.fftn(
            np.asarray(x[: 2 * check_b * n])
            .view(np.complex64)
            .reshape(check_b, *lengths),
            axes=tuple(range(1, 1 + len(lengths))),
        )
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel < 1e-2, rel
        gbytes = batch * n * 16 / 1e9
        return {
            "name": name, "label": "x".join(map(str, lengths)),
            "compute": plan.compute_forward, "inputs": [x], "y": y, "times": [],
            "flops": 5 * batch * n * math.log2(n),
            "tail": lambda t, g=gbytes, r=rel: (
                f" {g/t:7.1f} GB/s rel_err={r:.1e}"
            ),
        }

    def prep_df64(name, n, batch):
        import jax

        desc = pfft.Descriptor(
            lengths=[n], number_of_transforms=batch, precision="float64"
        )
        plan = desc.commit(emulate_fp64=True)
        xr = rng.standard_normal((batch, n))
        xi = rng.standard_normal((batch, n))
        rh = xr.astype(np.float32)
        rl = (xr - rh.astype(np.float64)).astype(np.float32)
        ih = xi.astype(np.float32)
        il = (xi - ih.astype(np.float64)).astype(np.float32)
        planes = tuple(jnp.asarray(p) for p in (rh, rl, ih, il))

        @jax.jit
        def f(a, b, c, d):
            (orh, orl), (oih, oil) = plan.apply((a, b), (c, d))
            # one plane that depends on all four outputs (a partial output
            # would let XLA dead-code the rest)
            return (orh + orl) + (oih + oil)

        compute = lambda tup: f(*tup)  # noqa: E731
        y = compute(planes)
        # accuracy record: df64 must actually be double-accurate
        ref = np.fft.fft(
            (xr[:2] + 1j * xi[:2]).astype(np.complex128), axis=1
        )
        got = np.asarray(y[:2]).astype(np.float64)
        rel = np.linalg.norm(
            got - (ref.real + ref.imag)
        ) / np.linalg.norm(ref.real + ref.imag)
        return {
            "name": name, "label": f"N={n}", "compute": compute,
            "inputs": [planes], "y": y, "times": [],
            "flops": 5 * batch * n * math.log2(n),
            "tail": lambda t, r=rel: f" rel_err={r:.1e} (df64)",
        }

    run_set(prep_extra, EXTRA_CONFIGS)
    run_set(prep_real, REAL_CONFIGS)
    run_set(prep_md, MULTIDIM_CONFIGS)
    run_set(prep_df64, DF64_CONFIGS)
    return recorded


def main():
    import jax

    from portfft_tpu.config import (
        card_description,
        device_peaks,
        enable_persistent_cache,
    )

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(
            f"bench.py measures a GPU; JAX found {dev.platform!r}",
            file=sys.stderr,
        )
        sys.exit(2)
    enable_persistent_cache()
    peaks = device_peaks(dev)
    card = card_description()
    # Device context dump (reference bench metadata, device_context.hpp:30-51)
    print(
        f"device: {dev.device_kind}, platform {dev.platform}, card {card}, "
        f"published peak {peaks.hbm_gbps} GB/s ({peaks.source}), "
        f"jax {jax.__version__}",
        file=sys.stderr,
    )

    rotate = 4 if "--rotate" in sys.argv else 0
    results = bench_group(CONFIGS, peaks.hbm_gbps, rotate)
    ladder_results = bench_group(LADDER_CONFIGS, peaks.hbm_gbps, rotate)
    if not results:
        sys.exit("no headline config ran")

    extra_results = {}
    if not ("--set" in sys.argv and "headline" in sys.argv):
        extra_results = bench_extra()

    def geomean(vals):
        return math.exp(sum(math.log(v) for v in vals) / len(vals))

    out = {
        "metric": "batched 1D C2C fp32 fwd GFLOP/s (geomean of portFFT bench set)",
        "value": round(geomean([r["gflops"] for r in results.values()]), 2),
        "unit": "GFLOP/s",
        "bandwidth_share": round(
            geomean([r["eff"] for r in results.values()]), 4
        ),
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(devs),
            "card": card,
        },
        "sets": {
            name: {"ms": round(r["ms"], 3), "gbps": round(r["gbps"], 1)}
            for name, r in {**results, **ladder_results}.items()
        }
        | extra_results,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
