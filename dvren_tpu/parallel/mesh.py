"""Device mesh construction helpers.

The reference has no distributed layer at all (SURVEY.md section 2.4); this
is the idiomatic JAX extension point: a 1-D (or user-shaped) ``jax.sharding
.Mesh`` whose axes carry data parallelism over rays/views, with XLA
collectives replacing the reference's "nothing". The GPUs of one host are
joined all to all, so a flat mesh needs no topology.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_mesh(n_devices: int | None = None,
              axis_name: str = "dp",
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} present")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def batch_sharded(mesh: Mesh, axis_name: str | None = None) -> NamedSharding:
    axis = axis_name or mesh.axis_names[0]
    return NamedSharding(mesh, PartitionSpec(axis))
