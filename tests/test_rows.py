"""Batched independent row sorts (sortx.sort_rows / sort_kv_rows).

Beyond-reference capability; oracle = numpy row-wise sort.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sortx


def _cfg():
    return sortx.Config()


@pytest.mark.parametrize("shape", [(64, 512), (33, 1000), (128, 256),
                                   (4, 8192), (1024, 32)])
def test_sort_rows_sweep(rng, shape):
    B, L = shape
    k = rng.randint(0, 2**32, size=(B, L), dtype=np.uint32)
    got = np.asarray(sortx.sort_rows(jnp.asarray(k), config=_cfg()))
    assert np.array_equal(got, np.sort(k, axis=1))


def test_sort_rows_dtypes(rng):
    B, L = 40, 1024
    f = rng.randn(B, L).astype(np.float32)
    got = np.asarray(sortx.sort_rows(jnp.asarray(f), config=_cfg()))
    assert np.array_equal(got, np.sort(f, axis=1))
    i = rng.randint(-2**31, 2**31, size=(B, L)).astype(np.int32)
    got = np.asarray(sortx.sort_rows(jnp.asarray(i), config=_cfg()))
    assert np.array_equal(got, np.sort(i, axis=1))


def test_sort_rows_ff_and_equal(rng):
    """Real 0xffffffff keys survive per-row pow2 padding; all-equal rows
    pass through."""
    B, L = 16, 1000
    k = rng.randint(0, 2**32, size=(B, L), dtype=np.uint32)
    k[:, ::7] = 0xFFFFFFFF
    k[3, :] = 0xABCD1234
    got = np.asarray(sortx.sort_rows(jnp.asarray(k), config=_cfg()))
    assert np.array_equal(got, np.sort(k, axis=1))


def test_sort_kv_rows_stability(rng):
    B, L = 24, 2000
    k = rng.randint(0, 17, size=(B, L)).astype(np.uint32)  # heavy dups
    v = np.tile(np.arange(L, dtype=np.uint32), (B, 1))
    ks, vs = sortx.sort_kv_rows(jnp.asarray(k), jnp.asarray(v),
                                config=_cfg())
    order = np.argsort(k, axis=1, kind="stable")
    assert np.array_equal(np.asarray(ks), np.take_along_axis(k, order, 1))
    assert np.array_equal(np.asarray(vs), np.take_along_axis(v, order, 1))


def test_sort_kv_rows_value_dtypes(rng):
    B, L = 8, 512
    k = rng.randint(0, 64, size=(B, L)).astype(np.uint32)
    order = np.argsort(k, axis=1, kind="stable")
    for vals in (rng.randn(B, L).astype(np.float32),
                 rng.randn(B, L).astype(np.float16)):
        ks, vs = sortx.sort_kv_rows(jnp.asarray(k), jnp.asarray(vals),
                                    config=_cfg())
        assert np.asarray(vs).dtype == vals.dtype
        assert np.array_equal(np.asarray(vs),
                              np.take_along_axis(vals, order, 1))


def test_sort_rows_xla_fallback_and_validation(rng):
    k = rng.randint(0, 2**32, size=(4, 32), dtype=np.uint32)
    got = np.asarray(sortx.sort_rows(jnp.asarray(k)))
    assert np.array_equal(got, np.sort(k, axis=1))
    with pytest.raises(ValueError):
        sortx.sort_rows(jnp.zeros((8,), jnp.uint32))
    with pytest.raises(TypeError):
        sortx.sort_rows(jnp.zeros((4, 8), jnp.uint8))
    with pytest.raises(ValueError):
        sortx.sort_kv_rows(jnp.zeros((4, 8), jnp.uint32),
                           jnp.zeros((4, 9), jnp.uint32))


def test_sort_rows_edge_shapes(rng):
    for shape in ((1, 2048), (3, 1), (0, 8)):
        k = rng.randint(0, 2**32, size=shape, dtype=np.uint32)
        got = np.asarray(sortx.sort_rows(jnp.asarray(k), config=_cfg()))
        assert np.array_equal(got, np.sort(k, axis=1))
