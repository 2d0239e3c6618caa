"""Double precision: native float64 under ``jax_enable_x64``, and the
opt-in double-double emulation for devices without native fp64
(~5e-15 relative error from float32 arithmetic)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import portfft_tpu as pfft  # noqa: E402

rng = np.random.default_rng(0)

# --- native fp64
desc = pfft.Descriptor(
    lengths=[4096], number_of_transforms=64, precision="float64"
)
plan = desc.commit()
x = (rng.standard_normal(64 * 4096) + 1j * rng.standard_normal(64 * 4096))
y = plan.compute_forward(x)
ref = np.fft.fft(x.reshape(64, 4096), axis=1).reshape(-1)
print("native fp64 rel err:", np.linalg.norm(y - ref) / np.linalg.norm(ref))

# --- emulated fp64 (opt-in; sizes need prime factors <= 128)
d64 = pfft.Descriptor(
    lengths=[360], number_of_transforms=8, precision="float64"
)
p64 = d64.commit(emulate_fp64=True)
x64 = rng.standard_normal(8 * 360) + 1j * rng.standard_normal(8 * 360)
y64 = p64.compute_forward(x64)
ref = np.fft.fft(x64.reshape(8, 360), axis=1).reshape(-1)
print("emulated fp64 rel err:", np.linalg.norm(y64 - ref) / np.linalg.norm(ref))
