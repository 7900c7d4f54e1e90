"""Compilation cache management + warmup.

Analog of the reference's on-disk kernel binary cache
(``KernelBuilder<TYPE_CL>``: cache keyed by source hash + device + driver,
``Adl/CL/AdlKernelUtilsCL.inl:176-337``). JAX/XLA ships a persistent
compilation cache with the same keying discipline (HLO hash + compiler
version + device); this module turns it on, points it at a directory
(``adl::s_cacheDirectory`` analog, ``Adl/Adl.h:19-20``), and provides a
warmup that pre-compiles the sort/scan kernels for a set of sizes.

Every entry point (``bench.py``, ``chip_smoke.py``, the test suite and
the benchmark scripts) calls ``enable_cache()``, so they share one rule:
``$JAX_COMPILATION_CACHE_DIR`` when it is set, else ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..utils.log import Channel, log

__all__ = ["cache_dir", "enable_cache", "warmup"]

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def cache_dir(environ=os.environ) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<repo>/.jax_cache``."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache")


def enable_cache(directory: str | None = None,
                 min_compile_secs: float = 0.0) -> str:
    """Enable the persistent XLA compilation cache (binary-cache analog).

    Goes through ``jax.config`` as well as the directory rule, because a
    process that imported jax before setting the variable has already
    read it. ``min_compile_secs=0`` persists every executable."""
    directory = os.path.abspath(directory or cache_dir())
    os.makedirs(directory, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", directory)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    log(f"compilation cache at {directory}", Channel.DEVICE)
    return directory


def warmup(sizes=(1 << 20,), kv: bool = True, scan_too: bool = True,
           config=None) -> None:
    """Pre-compile kernels for the given sizes (KernelManager cold-start
    analog: the reference compiles on first Launcher construction,
    ``Adl/AdlKernel.inl:18-108``)."""
    from .. import ops

    for n in sizes:
        k = jnp.zeros((n,), jnp.uint32)
        ops.sort(k, config=config).block_until_ready()
        if kv:
            v = jnp.zeros((n,), jnp.uint32)
            jax.block_until_ready(ops.sort_kv(k, v, config=config))
        if scan_too:
            x = jnp.zeros((n,), jnp.int32)
            jax.block_until_ready(ops.scan(x, config=config))
        log(f"warmup n={n} done", Channel.DEVICE)
