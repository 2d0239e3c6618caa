"""Device-mesh helpers for multi-chip execution.

The reference is a single-device library (SURVEY.md §2: no MPI/NCCL — its
only cross-"device" structure is the SYCL event DAG).  Multi-device support
here is a pure extension: batch data-parallelism rides a 1D mesh with no
collectives at all, and the distributed large-N transform (sharded.py)
shards the transform dimension with all-to-all collectives between the
devices.  The mesh is a plain grid over ``jax.devices()``: it follows the
algorithm's axes, not a physical topology.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("dp", "sp"),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    Default: all devices on a 1D ``dp`` (batch) axis.  Pass
    ``axis_sizes=(a, b)`` for a 2D (dp, sp) mesh used by the distributed
    transform.
    """
    if devices is None:
        devices = jax.devices()
    if axis_sizes is None:
        axis_sizes = (len(devices),)
        axis_names = axis_names[: len(axis_sizes)]
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        raise ValueError(
            f"mesh needs {n} devices, only {len(devices)} available"
        )
    arr = np.asarray(devices[:n]).reshape(axis_sizes)
    return Mesh(arr, axis_names[: len(axis_sizes)])
