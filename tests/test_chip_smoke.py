"""chip_smoke.py on the CPU: it refuses to run without a GPU, its output
check tells a HIGHEST-precision float32 result from a TF32-level one, and
each phase runs end to end at a tiny size (including the four-device
sharded phases on the virtual CPU mesh)."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

import portfft_tpu as pfft  # noqa: E402


def _run_script(cwd, script):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(script)],
        cwd=str(cwd),
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )


def test_refuses_cpu():
    res = _run_script(REPO, REPO / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs a GPU" in res.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_script(tmp_path, tmp_path / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _library_rows(n, batch, seed=0):
    plan = pfft.Descriptor(lengths=[n], number_of_transforms=batch).commit()
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-1, 1, (batch, n))
         + 1j * rng.uniform(-1, 1, (batch, n))).astype(np.complex64)
    got = np.asarray(plan.compute_forward(x.reshape(-1))).reshape(batch, n)
    return x, got, np.fft.fft(x.astype(np.complex128), axis=1)


SIZES = [(16, 512), (256, 64), (4096, 8), (65536, 2), (65537, 2)]


@pytest.mark.parametrize("n,batch", SIZES)
def test_check_accepts_highest(n, batch):
    _, got, ref = _library_rows(n, batch)
    assert chip_smoke.check_rows(got, ref, n, np.float32)["ok"]


@pytest.mark.parametrize("n,batch", SIZES)
def test_check_rejects_tf32_level_error(n, batch):
    """A relative perturbation of 1e-3 (TF32's ~3 decimal digits) fails,
    also at sizes where the per-element oracle bound alone would pass it."""
    _, got, ref = _library_rows(n, batch)
    rng = np.random.default_rng(1)
    noise = rng.standard_normal(got.shape) + 1j * rng.standard_normal(got.shape)
    bad = got + 1e-3 / np.sqrt(2) * np.abs(ref) * noise
    res = chip_smoke.check_rows(bad, ref, n, np.float32)
    assert not res["ok"]
    assert res["rel_l2"] > res["l2_bound"]


@pytest.mark.parametrize("n,batch", SIZES)
def test_check_rejects_tf32_rounded_input(n, batch):
    """The exact transform of the input rounded to TF32's 10-bit mantissa —
    the first rounding a TF32 matmul makes — fails the check."""
    x, _, ref = _library_rows(n, batch)

    def tf32(a):
        bits = np.asarray(a, np.float32).view(np.uint32)
        return ((bits + 0x1000) & 0xFFFFE000).view(np.float32)

    xt = tf32(x.real) + 1j * tf32(x.imag)
    got = np.fft.fft(xt.astype(np.complex128), axis=1)
    assert not chip_smoke.check_rows(got, ref, n, np.float32)["ok"]


def test_check_flags_nonfinite():
    ref = np.ones((2, 8), np.complex128)
    got = ref.copy()
    got[0, 0] = np.nan
    assert not chip_smoke.check_rows(got, ref, 8, np.float32)["ok"]


@pytest.mark.parametrize(
    "batch,n", [(8 * 1024 * 1024, 16), (2048, 65536), (128, 1 << 20), (7, 4096)]
)
def test_sample_rows(batch, n):
    rows = chip_smoke.sample_rows(batch, n, seed=0)
    assert rows[0] == 0 and rows[-1] == batch - 1
    assert np.all(np.diff(rows) > 0)
    assert len(rows) >= min(batch, 512) or len(rows) * n >= (1 << 26) // 2
    assert len(rows) * n <= (1 << 26) + 2 * n


@pytest.fixture
def smoke():
    return chip_smoke.Smoke(seed=0, iters=1)


PHASES = {
    "c2c_forward": lambda s: s.c2c(64, 16),
    "c2c_backward": lambda s: s.c2c(256, 8, "backward"),
    "c2c_global": lambda s: s.c2c(65536, 2),
    "c2c_bluestein": lambda s: s.c2c(1031, 4),
    "real": lambda s: s.real(2048, 4),
    "multidim": lambda s: s.multidim((16, 32), 4),
    "strided": lambda s: s.strided(128, 4, 2),
    "split": lambda s: s.split(256, 8),
    "functional": lambda s: s.functional(256, 8),
    "apply_grad": lambda s: s.apply_grad(256, 8),
    "fp64": lambda s: s.fp64(256, 8),
    "four_batch_parallel": lambda s: s.sharded(1024, 8, seq=False),
    "four_seq_sharded": lambda s: s.sharded(4096, 2, seq=True),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_runs_on_cpu(smoke, phase, capsys):
    if phase.startswith("four") and len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    smoke.run(phase, lambda: PHASES[phase](smoke))
    out = capsys.readouterr().out
    assert smoke.failed == [], out
    assert "[PASS]" in out and "[FAIL]" not in out


def test_unchunked_comparison(smoke, monkeypatch, capsys):
    """A chunked headline phase also times the same plan with the chunk
    budget lifted, and checks that output too."""
    import dataclasses

    from portfft_tpu import committed

    small = dataclasses.replace(pfft.DeviceConfig(), hbm_chunk_bytes=1 << 14)
    real_resolve = committed.resolve_device_config
    monkeypatch.setattr(
        committed,
        "resolve_device_config",
        lambda d=None: d if isinstance(d, pfft.DeviceConfig) else small,
    )
    assert real_resolve() != small
    smoke.run("c2c", lambda: smoke.c2c(64, 64, unchunked=True))
    out = capsys.readouterr().out
    assert smoke.failed == [], out
    assert "chunked=yes" in out and "unchunked" in out


def test_precision_phase_passes_when_tf32_is_rejected(
    smoke, monkeypatch, capsys
):
    """With the reduced modes made TF32-like (operands rounded to a 10-bit
    mantissa, as a TF32 matmul does), the check rejects both and the phase
    passes."""
    from portfft_tpu.ops import xla_fft

    exact = xla_fft.complex_matmul_last

    def tf32_matmul(xr, xi, wr, wi, precision=None):
        if xla_fft.resolve_precision(precision) != jax.lax.Precision.HIGHEST:
            xr, xi, wr, wi = (
                jax.lax.reduce_precision(a, exponent_bits=8, mantissa_bits=10)
                for a in (xr, xi, wr, wi)
            )
        return exact(xr, xi, wr, wi, precision)

    monkeypatch.setattr(xla_fft, "complex_matmul_last", tf32_matmul)
    smoke.run("precision", lambda: smoke.precision_modes(512, 16))
    out = capsys.readouterr().out
    assert smoke.failed == [], out
    assert out.count("rejected") == 2 and "[FAIL]" not in out


def test_precision_phase_fails_when_a_mode_is_accepted(smoke, capsys):
    """The CPU runs every precision in full float32, so the check accepts
    the reduced modes and the phase fails."""
    smoke.run("precision", lambda: smoke.precision_modes(1024, 8))
    out = capsys.readouterr().out
    assert smoke.failed == ["precision"]
    assert "accepted" in out and "[FAIL] precision: exception" in out


def test_failed_phase_is_recorded(smoke, capsys):
    def boom():
        raise RuntimeError("phase broke")

    smoke.run("boom", boom)
    assert smoke.failed == ["boom"]
    assert "[FAIL] boom" in capsys.readouterr().out
