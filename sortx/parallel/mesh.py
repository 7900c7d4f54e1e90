"""Device mesh helpers for the distributed sort.

No counterpart in the reference (single-device library; SURVEY §2.6 #5,
§5 "Distributed communication backend: absent") — this is the new-scope
communication layer: a 1D mesh over all chips with even 1D sharding of the key
axis.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_sort_mesh", "shard_1d", "AXIS"]

AXIS = "x"


def make_sort_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1D mesh over the given (or all) devices, axis name 'x'."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (AXIS,), devices=devices)


def shard_1d(x, mesh: Mesh):
    """Place a 1D array with its single axis sharded over the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(AXIS)))
