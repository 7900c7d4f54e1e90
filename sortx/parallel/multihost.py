"""Multi-host initialization and mesh construction.

New scope (the reference is single-device): helpers to run the
distributed sort across hosts. Call ``init_multihost()`` once per
process before building meshes; the resulting global mesh spans all
hosts' devices and ``dist_sort`` works unchanged (shard_map +
collectives).

For CI / single-machine development, ``simulate_hosts`` documents the
supported recipe: N virtual CPU devices via
``--xla_force_host_platform_device_count`` (tests/conftest.py does this),
which exercises the identical shard_map/collective code paths.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from ..utils.log import Channel, log

__all__ = ["init_multihost", "is_multihost", "host_count",
           "simulate_hosts_flags"]


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize JAX distributed (one call per host process).

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS
    etc.) where the cluster sets them; elsewhere pass all three.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    log(f"multihost init: process {jax.process_index()}/"
        f"{jax.process_count()}, {len(jax.devices())} global devices",
        Channel.DEVICE)


def is_multihost() -> bool:
    return jax.process_count() > 1


def host_count() -> int:
    return jax.process_count()


def simulate_hosts_flags(n_devices: int = 8) -> dict:
    """Env vars that simulate an n-device mesh on CPU (for CI).

    Must be set before the first jax import (or backend init):
      XLA_FLAGS=--xla_force_host_platform_device_count=N
      plus forcing the cpu platform (see tests/conftest.py for the
      config-based override this environment requires).
    """
    flags = os.environ.get("XLA_FLAGS", "")
    return {
        "XLA_FLAGS": (flags +
                      f" --xla_force_host_platform_device_count={n_devices}"
                      ).strip(),
        "JAX_PLATFORMS": "cpu",
    }
