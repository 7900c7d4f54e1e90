"""merge / merge_kv tests (beyond-reference primitive, ops/merge.py).

Oracle: numpy. For keys-only, the merged output must equal the sorted
concatenation. For KV, stability is the std::merge contract — equal
keys take a's elements first, each input's internal order preserved —
which is exactly what a stable argsort over the concatenation yields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sortx


def _oracle_kv(ka, va, kb, vb, descending=False):
    k = np.concatenate([ka, kb])
    v = np.concatenate([va, vb])
    order = np.argsort(-k.astype(np.int64) if descending else k,
                       kind="stable")
    return k[order], v[order]


def _merge(a, b, jit, **kw):
    """sortx.merge, called eagerly or under jax.jit."""
    f = (lambda x, y: sortx.merge(x, y, **kw))
    return np.asarray((jax.jit(f) if jit else f)(jnp.asarray(a),
                                                  jnp.asarray(b)))


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("na,nb", [(5000, 4096), (8192, 8192),
                                   (1, 20_000), (30_000, 7)])
def test_merge_keys(rng, dtype, na, nb):
    lo, hi = (0, 2**32) if dtype == np.uint32 else (-2**31, 2**31)
    a = np.sort(rng.randint(lo, hi, size=na, dtype=np.int64).astype(dtype))
    b = np.sort(rng.randint(lo, hi, size=nb, dtype=np.int64).astype(dtype))
    got = _merge(a, b, False)
    assert np.array_equal(got, np.sort(np.concatenate([a, b])))


@pytest.mark.parametrize("distinct", [1, 7])
def test_merge_duplicate_heavy(rng, distinct):
    a = np.sort(rng.randint(0, distinct, size=9000).astype(np.uint32))
    b = np.sort(rng.randint(0, distinct, size=9000).astype(np.uint32))
    got = _merge(a, b, False)
    assert np.array_equal(got, np.sort(np.concatenate([a, b])))


@pytest.mark.parametrize("max_side", ["a", "b"])
def test_merge_max_keys_vs_padding(rng, max_side):
    # Legitimate 0xffffffff keys must survive the pad-slot slice, on
    # either side of the merge.
    a = np.sort(np.concatenate([
        rng.randint(0, 2**32, size=5000).astype(np.uint32),
        np.full(200, 0xFFFFFFFF, np.uint32)]))
    b = np.full(4000, 0xFFFFFFFF, np.uint32)
    if max_side == "a":
        a, b = b, a
    got = _merge(a, b, False)
    assert np.array_equal(got, np.sort(np.concatenate([a, b])))


def test_merge_empty(rng):
    a = np.sort(rng.randint(0, 2**32, size=64).astype(np.uint32))
    e = np.empty(0, np.uint32)
    got = np.asarray(sortx.merge(jnp.asarray(a), jnp.asarray(e)))
    assert np.array_equal(got, a)
    got = np.asarray(sortx.merge(jnp.asarray(e), jnp.asarray(a)))
    assert np.array_equal(got, a)


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_merge_signed_float(rng, jit, dtype):
    if dtype == np.int32:
        a = np.sort(rng.randint(-2**31, 2**31, size=9000).astype(dtype))
        b = np.sort(rng.randint(-1000, 1000, size=8000).astype(dtype))
    else:
        a = np.sort(rng.standard_normal(9000).astype(dtype))
        b = np.sort((rng.standard_normal(8000) * 100).astype(dtype))
    got = _merge(a, b, jit)
    assert np.array_equal(got, np.sort(np.concatenate([a, b])))


@pytest.mark.parametrize("dtype", [np.uint32, np.float32])
def test_merge_descending(rng, dtype):
    if dtype == np.uint32:
        a = np.sort(rng.randint(0, 2**32, size=9000).astype(dtype))[::-1]
        b = np.sort(rng.randint(0, 2**32, size=8000).astype(dtype))[::-1]
    else:
        a = np.sort(rng.standard_normal(9000).astype(dtype))[::-1]
        b = np.sort(rng.standard_normal(8000).astype(dtype))[::-1]
    got = _merge(a.copy(), b.copy(), False, descending=True)
    exp = np.sort(np.concatenate([a, b]))[::-1]
    assert np.array_equal(got, exp)


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("na,nb", [(9000, 8000), (8192, 8192)])
def test_merge_kv_stability(rng, jit, na, nb):
    # Duplicate-heavy keys; values tag (source, position) so the
    # std::merge tie order (a first, input order preserved) is checked
    # exactly.
    ka = np.sort(rng.randint(0, 50, size=na).astype(np.uint32))
    kb = np.sort(rng.randint(0, 50, size=nb).astype(np.uint32))
    va = np.arange(na, dtype=np.uint32)
    vb = (np.arange(nb, dtype=np.uint32) | np.uint32(1 << 31))
    f = jax.jit(sortx.merge_kv) if jit else sortx.merge_kv
    ks, vs = f(jnp.asarray(ka), jnp.asarray(va), jnp.asarray(kb),
               jnp.asarray(vb))
    ek, ev = _oracle_kv(ka, va, kb, vb)
    assert np.array_equal(np.asarray(ks), ek)
    assert np.array_equal(np.asarray(vs), ev)


@pytest.mark.parametrize("na,nb", [(9000, 6000), (1, 5000)])
def test_merge_kv_descending_stability(rng, na, nb):
    ka = np.sort(rng.randint(0, 50, size=na).astype(np.uint32))[::-1].copy()
    kb = np.sort(rng.randint(0, 50, size=nb).astype(np.uint32))[::-1].copy()
    va = np.arange(na, dtype=np.uint32)
    vb = (np.arange(nb, dtype=np.uint32) | np.uint32(1 << 31))
    ks, vs = sortx.merge_kv(jnp.asarray(ka), jnp.asarray(va),
                            jnp.asarray(kb), jnp.asarray(vb),
                            descending=True)
    ek, ev = _oracle_kv(ka, va, kb, vb, descending=True)
    assert np.array_equal(np.asarray(ks), ek)
    assert np.array_equal(np.asarray(vs), ev)


def test_merge_kv_float_values(rng):
    na, nb = 500, 300
    ka = np.sort(rng.randint(0, 9, size=na).astype(np.uint32))
    kb = np.sort(rng.randint(0, 9, size=nb).astype(np.uint32))
    va = rng.standard_normal(na).astype(np.float32)
    vb = rng.standard_normal(nb).astype(np.float32)
    ks, vs = sortx.merge_kv(jnp.asarray(ka), jnp.asarray(va),
                            jnp.asarray(kb), jnp.asarray(vb))
    ek, ev = _oracle_kv(ka, va, kb, vb)
    assert np.array_equal(np.asarray(ks), ek)
    assert np.array_equal(np.asarray(vs), ev)
    assert vs.dtype == jnp.float32


def test_merge_type_errors(rng):
    a = jnp.zeros(8, jnp.uint32)
    with pytest.raises(TypeError):
        sortx.merge(a, jnp.zeros(8, jnp.int32))
    with pytest.raises(TypeError):
        sortx.merge(a, jnp.zeros(8, jnp.float16))
    with pytest.raises(ValueError):
        sortx.merge_kv(a, jnp.zeros(4, jnp.uint32), a, a)


def test_merge_jit(rng):
    a = np.sort(rng.randint(0, 2**32, size=2048).astype(np.uint32))
    b = np.sort(rng.randint(0, 2**32, size=1024).astype(np.uint32))
    got = jax.jit(sortx.merge)(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(np.asarray(got),
                          np.sort(np.concatenate([a, b])))
