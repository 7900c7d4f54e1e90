"""Test harness configuration.

Mirrors the reference's UnitTest strategy (SURVEY.md §4): fixed seeds,
CPU golden oracle, size sweeps. The suite runs on whatever platform
``JAX_PLATFORMS`` names; the CPU backend gets 8 virtual devices, so the
multi-device sharding paths execute without a device cluster.

Tests that need a GPU carry ``@pytest.mark.gpu`` and skip elsewhere
(decided in a fixture, never at import). Run them on a machine with a
card: ``python -m pytest tests/ -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import subprocess
import sys

import numpy as np
import pytest

from sortx.runtime.cache import enable_cache

# Threshold 0 persists EVERY executable (the default 1 s threshold skips
# most of the suite's many small XLA:CPU programs): warm reruns of
# compile-bound files are ~2x faster.
enable_cache(min_compile_secs=0.0)

# Build the native host-sort oracle once if the toolchain is present
# (test_native skips on a machine without one).
_r = subprocess.run(["make", "-C", os.path.join(os.path.dirname(__file__),
                                                "..", "csrc")],
                    capture_output=True, text=True)
if _r.returncode != 0:
    print(f"conftest: native oracle build failed (test_native will "
          f"skip):\n{_r.stderr[-500:]}", file=sys.stderr)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX's backend is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run `python -m pytest tests/ -m gpu` on "
                    "a machine with one")


@pytest.fixture
def multi_device():
    """The default mesh's devices; skips with fewer than two."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs >=2 devices")
    return jax.devices()


@pytest.fixture
def native_lib():
    """The built csrc library; skips where it could not be built."""
    from sortx.runtime import native

    if not native.available():
        pytest.skip("build/libsortx_host.so not built (make -C csrc)")
    return native


@pytest.fixture(autouse=True, scope="module")
def _bounded_jax_caches():
    """Clear jax's in-process caches after each test module.

    Measured: the full suite in ONE process ran ~1.8x slower than the
    sum of fresh per-file runs — the jaxpr/executable caches grow across
    hundreds of tests and every trace and GC pass slows with the
    live-object count. Per-module clearing bounds the growth.
    """
    yield
    import gc

    import jax

    jax.clear_caches()
    gc.collect()


@pytest.fixture
def rng():
    # Reference seeds rand with 123 per size (UnitTest/main.cpp:109,77).
    return np.random.RandomState(123)


def sweep_sizes(max_full=2 * 1024 * 1024):
    """The reference sweep: 1024, 2048, ... <2M (UnitTest/main.cpp:105)."""
    s, out = 1024, []
    while s < max_full:
        out.append(s)
        s *= 2
    return out


def kv_sweep_sizes():
    """KV sweep with cumulative +13 raggedness (UnitTest/main.cpp:144)."""
    out, size = [], 1024
    while size < 2 * 1024 * 1024:
        size += 13
        out.append(size)
        size *= 2
    return out

