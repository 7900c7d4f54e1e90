"""Key-value sort tests: Demo.SortKeyValue analog (UnitTest/main.cpp:143-170).

Values are the original indices, so comparing values verifies STABILITY
(the reference golden sort is stable; UnitTest/main.cpp:152,165-166).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sortx
from sortx import reference
from tests.conftest import kv_sweep_sizes


@pytest.mark.parametrize("n", kv_sweep_sizes())
def test_sort_kv_ragged_sweep(rng, n):
    """The reference's only ragged-n coverage: the +13 KV sweep."""
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    gk, gv = reference.radix_sort_kv(keys, vals)
    ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    assert np.array_equal(np.asarray(ks), gk), n
    assert np.array_equal(np.asarray(vs), gv), n


def test_sort_kv_duplicate_heavy_stability(rng):
    """Stability under heavy duplication (16 distinct keys in 100K)."""
    keys = rng.randint(0, 16, size=100_000).astype(np.uint32)
    vals = np.arange(100_000, dtype=np.uint32)
    gk, gv = reference.radix_sort_kv(keys, vals)
    ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    assert np.array_equal(np.asarray(ks), gk)
    assert np.array_equal(np.asarray(vs), gv)


def test_sort_kv_partial_bits(rng):
    keys = rng.randint(0, 2**32, size=9999, dtype=np.uint32)
    vals = np.arange(9999, dtype=np.uint32)
    gk, gv = reference.radix_sort_kv(keys, vals, sort_bits=12)
    ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals), 12)
    assert np.array_equal(np.asarray(ks), gk)
    assert np.array_equal(np.asarray(vs), gv)


def test_sort_kv_all_equal_keys_keeps_value_order():
    n = 50_000
    keys = np.full(n, 42, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    assert np.array_equal(np.asarray(vs), vals)


def test_sort_kv_shape_mismatch():
    with pytest.raises(ValueError):
        sortx.sort_kv(jnp.zeros((8,), jnp.uint32), jnp.zeros((9,), jnp.uint32))
