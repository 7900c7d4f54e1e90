"""The compile-cache path rule every entry point shares."""

import os

import jax
import pytest

from sortx.runtime import cache

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_cache_dir_honours_the_environment_variable(tmp_path):
    d = str(tmp_path / "cc")
    assert cache.cache_dir({"JAX_COMPILATION_CACHE_DIR": d}) == d


@pytest.mark.parametrize("environ", [{}, {"JAX_COMPILATION_CACHE_DIR": ""}])
def test_cache_dir_defaults_to_the_repo(environ):
    assert cache.cache_dir(environ) == os.path.join(_REPO, ".jax_cache")


def test_enable_cache_points_jax_at_the_directory(tmp_path):
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        d = cache.enable_cache(str(tmp_path / "c"), min_compile_secs=0.25)
        assert os.path.isdir(d)
        assert jax.config.jax_compilation_cache_dir == d
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.25
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_min)


def test_entry_points_use_the_shared_helper():
    """bench.py, chip_smoke.py, the test harness and the benchmark
    scripts all go through enable_cache(), so JAX_COMPILATION_CACHE_DIR
    means the same everywhere."""
    for rel in ("bench.py", "chip_smoke.py", "tests/conftest.py",
                "benchmarks/bench_multihost.py"):
        with open(os.path.join(_REPO, rel)) as f:
            src = f.read()
        assert "enable_cache(" in src, rel
        assert "jax_compilation_cache_dir" not in src, rel
