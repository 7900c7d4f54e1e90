"""Descending-order option across the API surface.

Beyond-reference capability (the reference sorts ascending only,
``Pprims.cpp:304-406``): every sort entry point takes ``descending=``,
implemented as a complement of the radix-u32 key around the ascending
sort — so it must be stable (equal keys keep original order) and
bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sortx

N = 20_000


def test_sort_descending_u32(rng):
    keys = rng.randint(0, 2**32, size=N, dtype=np.uint32)
    exp = np.sort(keys)[::-1]
    got = np.asarray(sortx.sort(jnp.asarray(keys), descending=True))
    assert np.array_equal(got, exp)


def test_sort_descending_i32_f32(rng):
    i = rng.randint(-2**31, 2**31, size=N).astype(np.int32)
    f = rng.randn(N).astype(np.float32)
    gi = np.asarray(sortx.sort(jnp.asarray(i), descending=True))
    assert np.array_equal(gi, np.sort(i)[::-1])
    gf = np.asarray(sortx.sort(jnp.asarray(f), descending=True))
    assert np.array_equal(gf, np.sort(f)[::-1])


def test_sort_descending_partial_bits(rng):
    """Low-bits descending order, stable, full keys preserved."""
    keys = rng.randint(0, 2**32, size=N, dtype=np.uint32)
    mask = np.uint32(0xFF)
    order = np.argsort((keys & mask) ^ mask, kind="stable")
    exp = keys[order]
    got = np.asarray(sortx.sort(jnp.asarray(keys), 8, descending=True))
    assert np.array_equal(got, exp)


def test_sort_descending_ragged_and_presorted(rng):
    for n in (1, 13, 255, 1000, 8193):
        keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
        exp = np.sort(keys)[::-1]
        got = np.asarray(sortx.sort(jnp.asarray(keys), descending=True))
        assert np.array_equal(got, exp), n
    # A reverse-sorted (= already descending) input must be an identity.
    pre = np.sort(rng.randint(0, 2**32, size=N, dtype=np.uint32))[::-1]
    got = np.asarray(sortx.sort(jnp.asarray(pre.copy()),
                                descending=True))
    assert np.array_equal(got, pre)


def test_sort_kv_descending_stable(rng):
    keys = rng.randint(0, 16, size=N).astype(np.uint32)   # heavy ties
    vals = np.arange(N, dtype=np.uint32)
    order = np.argsort(~keys, kind="stable")
    ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                           descending=True)
    assert np.array_equal(np.asarray(ks), keys[order])
    assert np.array_equal(np.asarray(vs), vals[order])


def test_sort_kv_descending_unstable_valid(rng):
    """stable=False: keys descending; (key, value) multiset preserved."""
    keys = rng.randint(0, 1024, size=1 << 14).astype(np.uint32)
    vals = rng.randint(0, 2**32, size=1 << 14, dtype=np.uint32)
    ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                           stable=False, descending=True)
    ks, vs = np.asarray(ks), np.asarray(vs)
    assert np.array_equal(ks, np.sort(keys)[::-1])
    got = np.stack([ks, vs], 1)
    exp = np.stack([keys, vals], 1)
    assert np.array_equal(
        got[np.lexsort((vs, ks))], exp[np.lexsort((vals, keys))]
    )


def test_argsort_descending(rng):
    keys = rng.randint(0, 64, size=N).astype(np.uint32)
    f = rng.randn(N).astype(np.float32)
    p = np.asarray(sortx.argsort(jnp.asarray(keys), descending=True))
    assert np.array_equal(p, np.argsort(~keys, kind="stable"))
    pf = np.asarray(sortx.argsort(jnp.asarray(f), descending=True))
    assert np.array_equal(pf, np.argsort(-f, kind="stable"))


def test_sort_u64_descending(rng):
    hi = rng.randint(0, 4, size=N).astype(np.uint32)       # tie-heavy hi
    lo = rng.randint(0, 2**32, size=N, dtype=np.uint32)
    full = (hi.astype(np.uint64) << 32) | lo
    exp = np.sort(full)[::-1]
    shi, slo = sortx.sort_u64(jnp.asarray(hi), jnp.asarray(lo),
                              descending=True)
    got = (np.asarray(shi).astype(np.uint64) << 32) | np.asarray(slo)
    assert np.array_equal(got, exp)


def test_sort_kv_u64_descending_stable(rng):
    hi = rng.randint(0, 4, size=N).astype(np.uint32)
    lo = rng.randint(0, 8, size=N).astype(np.uint32)
    vals = np.arange(N, dtype=np.uint32)
    full = (hi.astype(np.uint64) << 32) | lo
    order = np.argsort(np.invert(full), kind="stable")
    shi, slo, sv = sortx.sort_kv_u64(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals),
        descending=True)
    got = (np.asarray(shi).astype(np.uint64) << 32) | np.asarray(slo)
    assert np.array_equal(got, full[order])
    assert np.array_equal(np.asarray(sv), vals[order])


@pytest.mark.parametrize("shape", [(32, 640), (7, 1000)])
def test_sort_rows_descending(rng, shape):
    keys = rng.randint(0, 2**32, size=shape, dtype=np.uint32)
    exp = np.sort(keys, axis=1)[:, ::-1]
    got = np.asarray(sortx.sort_rows(jnp.asarray(keys),
                                     descending=True))
    assert np.array_equal(got, exp)


def test_sort_kv_rows_descending_stable(rng):
    B, L = 16, 2000
    keys = rng.randint(0, 8, size=(B, L)).astype(np.uint32)
    vals = np.tile(np.arange(L, dtype=np.uint32), (B, 1))
    order = np.argsort(~keys, axis=1, kind="stable")
    ks, vs = sortx.sort_kv_rows(jnp.asarray(keys), jnp.asarray(vals),
                                descending=True)
    assert np.array_equal(np.asarray(ks),
                          np.take_along_axis(keys, order, 1))
    assert np.array_equal(np.asarray(vs),
                          np.take_along_axis(vals, order, 1))


def test_dist_sort_descending(rng):
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = sortx.make_sort_mesh()
    keys = rng.randint(0, 2**32, size=1 << 16, dtype=np.uint32)
    got = np.asarray(sortx.dist_sort(jnp.asarray(keys), descending=True,
                                     mesh=mesh))
    assert np.array_equal(got, np.sort(keys)[::-1])

    vals = np.arange(1 << 16, dtype=np.uint32)
    tie = (keys & 0xFF).astype(np.uint32)
    order = np.argsort(~tie, kind="stable")
    ks, vs = sortx.dist_sort_kv(jnp.asarray(tie), jnp.asarray(vals),
                                descending=True, mesh=mesh)
    assert np.array_equal(np.asarray(ks), tie[order])
    assert np.array_equal(np.asarray(vs), vals[order])


def test_dist_sort_padded_descending(rng):
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = sortx.make_sort_mesh()
    n = (1 << 16) + 999                                    # ragged
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    out, pad = sortx.dist_sort_padded(jnp.asarray(keys), descending=True,
                                      mesh=mesh)
    out = np.asarray(out)
    assert np.array_equal(out[:n], np.sort(keys)[::-1])
    assert out.shape[0] - int(pad) == n
