"""Test configuration: run on the CPU with 8 virtual devices.

Mirrors the reference's approach of running the same test suite on whatever
device is available (SURVEY.md §4); unit tests target the CPU backend, with
an 8-device virtual mesh for the parallel/ suites.  What only a GPU can show
(compilation for the card, speed, TF32 versus full float32) is checked by
``python chip_smoke.py`` on the card.
"""

import os

# Force the CPU backend even where a GPU is visible, before JAX starts.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
