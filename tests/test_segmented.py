"""Segmented sort: ragged independent segments via the composite-key
engine (ops/segmented.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

import sortx


def _ragged_offsets(rng, n, s):
    cuts = np.sort(rng.randint(0, n + 1, size=s - 1))
    return np.concatenate([[0], cuts, [n]]).astype(np.int32)


def _oracle(keys, offsets, descending=False):
    out = keys.copy()
    for a, b in zip(offsets[:-1], offsets[1:]):
        seg = np.sort(out[a:b])
        out[a:b] = seg[::-1] if descending else seg
    return out


@pytest.mark.parametrize("s", [1, 2, 17, 300])
def test_sort_segments_ragged(rng, s):
    n = 30_000
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    offsets = _ragged_offsets(rng, n, s)
    exp = _oracle(keys, offsets)
    got = np.asarray(sortx.sort_segments(
        jnp.asarray(keys), jnp.asarray(offsets)))
    assert np.array_equal(got, exp), s


def test_sort_segments_descending_and_dtypes(rng):
    n = 20_000
    offsets = _ragged_offsets(rng, n, 33)
    f = rng.randn(n).astype(np.float32)
    i = rng.randint(-2**31, 2**31, size=n).astype(np.int32)
    gf = np.asarray(sortx.sort_segments(
        jnp.asarray(f), jnp.asarray(offsets), descending=True))
    assert np.array_equal(gf, _oracle(f, offsets, True))
    gi = np.asarray(sortx.sort_segments(
        jnp.asarray(i), jnp.asarray(offsets)))
    assert np.array_equal(gi, _oracle(i, offsets))


def test_sort_segments_extreme_skew(rng):
    """1-element segments next to one giant segment, plus empties."""
    n = 25_000
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    offsets = np.array([0, 1, 1, 1, 2, 3, n - 1, n, n], dtype=np.int32)
    exp = _oracle(keys, offsets)
    got = np.asarray(sortx.sort_segments(
        jnp.asarray(keys), jnp.asarray(offsets)))
    assert np.array_equal(got, exp)


def test_sort_kv_segments_stable(rng):
    n = 20_000
    keys = rng.randint(0, 8, size=n).astype(np.uint32)   # heavy ties
    vals = np.arange(n, dtype=np.uint32)
    offsets = _ragged_offsets(rng, n, 25)
    # Per-segment stable oracle.
    ek, ev = keys.copy(), vals.copy()
    for a, b in zip(offsets[:-1], offsets[1:]):
        order = np.argsort(ek[a:b], kind="stable")
        ek[a:b], ev[a:b] = ek[a:b][order], ev[a:b][order]
    ks, vs = sortx.sort_kv_segments(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(offsets))
    assert np.array_equal(np.asarray(ks), ek)
    assert np.array_equal(np.asarray(vs), ev)


def test_sort_segments_validation(rng):
    keys = jnp.zeros(10, jnp.uint32)
    with pytest.raises(ValueError):
        sortx.sort_segments(keys, jnp.asarray([0], jnp.int32))
    with pytest.raises(TypeError):
        sortx.sort_segments(keys.astype(jnp.uint8),
                            jnp.asarray([0, 10], jnp.int32))


def test_sort_segments_jit(rng):
    """Whole segmented sort is one jittable program."""
    import jax
    n = 4096
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    offsets = _ragged_offsets(rng, n, 7)
    f = jax.jit(lambda k, o: sortx.sort_segments(k, o))
    got = np.asarray(f(jnp.asarray(keys), jnp.asarray(offsets)))
    assert np.array_equal(got, _oracle(keys, offsets))
