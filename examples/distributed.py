"""Distributed large-N transform over a device mesh (run with
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu for a
virtual mesh, or on a host with several GPUs)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import jax
import jax.numpy as jnp
import numpy as np

from portfft_tpu.parallel.mesh import make_mesh
from portfft_tpu.parallel.sharded import DistributedFFT

N = 1 << 16
mesh = make_mesh((len(jax.devices()),), ("sp",))
dfft = DistributedFFT(N, mesh)

rng = np.random.default_rng(0)
xr = jax.device_put(jnp.asarray(rng.standard_normal((4, N)).astype(np.float32)), dfft.input_sharding())
xi = jax.device_put(jnp.asarray(rng.standard_normal((4, N)).astype(np.float32)), dfft.input_sharding())

yr, yi = dfft.forward(xr, xi)
print("output sharding devices:", len(yr.sharding.device_set))
