"""Order statistics (ops/select.py): kth_value / median / top_k."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sortx


@pytest.mark.parametrize("n", [1, 2, 1000, 16_384, 65_537])
def test_kth_value_sweep(rng, n):
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    srt = np.sort(keys)
    for k in {0, n // 2, n - 1}:
        got = sortx.kth_value(jnp.asarray(keys), k)
        assert np.uint32(got) == srt[k], (n, k)


def test_kth_value_dtypes_and_median(rng):
    n = 50_000
    i = rng.randint(-2**31, 2**31, size=n).astype(np.int32)
    f = rng.randn(n).astype(np.float32)
    gi = sortx.kth_value(jnp.asarray(i), 12_345)
    assert np.int32(gi) == np.sort(i)[12_345]
    gf = sortx.kth_value(jnp.asarray(f), n - 1)
    assert np.float32(gf) == np.sort(f)[-1]
    gm = sortx.median(jnp.asarray(f))
    assert np.float32(gm) == np.sort(f)[(n - 1) // 2]


def test_kth_value_duplicates_and_traced_k(rng):
    keys = np.repeat(
        rng.randint(0, 50, size=100).astype(np.uint32), 500)
    rng.shuffle(keys)
    srt = np.sort(keys)
    got = sortx.kth_value(jnp.asarray(keys), 25_000)
    assert np.uint32(got) == srt[25_000]
    # traced rank under jit
    f = jax.jit(lambda x, k: sortx.kth_value(x, k))
    got = f(jnp.asarray(keys), jnp.int32(49_999))
    assert np.uint32(got) == srt[49_999]


def test_kth_value_validation():
    with pytest.raises(ValueError):
        sortx.kth_value(jnp.zeros(10, jnp.uint32), 10)
    with pytest.raises(ValueError):
        sortx.kth_value(jnp.zeros(0, jnp.uint32), 0)


@pytest.mark.parametrize("n,k", [(100, 5), (8192, 1), (8192, 37),
                                 (100_000, 37), (65_536, 1000),
                                 (30_000, 30_000)])
def test_top_k_values(rng, n, k):
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    exp = np.sort(keys)[::-1][:k]
    got = np.asarray(sortx.top_k(jnp.asarray(keys), k))
    assert np.array_equal(got, exp), (n, k)


def test_top_k_indices_match_lax(rng):
    """Tie semantics == jax.lax.top_k (lowest index wins)."""
    n = 100_000
    keys = rng.randint(0, 256, size=n).astype(np.uint32)  # heavy ties
    ev, ei = jax.lax.top_k(jnp.asarray(keys), 512)
    gv, gi = sortx.top_k(jnp.asarray(keys), 512, return_indices=True)
    assert np.array_equal(np.asarray(gv), np.asarray(ev))
    assert np.array_equal(np.asarray(gi), np.asarray(ei))


def test_top_k_floats_and_ragged_tail(rng):
    n = 50_001                                            # ragged tail
    f = rng.randn(n).astype(np.float32)
    ev, ei = jax.lax.top_k(jnp.asarray(f), 65)
    gv, gi = sortx.top_k(jnp.asarray(f), 65, return_indices=True)
    assert np.array_equal(np.asarray(gv), np.asarray(ev))
    assert np.array_equal(np.asarray(gi), np.asarray(ei))


def test_top_k_validation():
    with pytest.raises(ValueError):
        sortx.top_k(jnp.zeros(10, jnp.uint32), 0)
    with pytest.raises(ValueError):
        sortx.top_k(jnp.zeros(10, jnp.uint32), 11)
