"""64-bit key dtypes (u64/i64/f64) — the (hi, lo) word path.

Requires jax x64 mode; every test runs under the ``enable_x64`` context
so the default-off global config is untouched for the rest of the suite.
Oracle: numpy sorts (the (hi, lo) word transform must reproduce natural
u64/i64/f64 order exactly).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sortx


@contextlib.contextmanager
def enable_x64():
    """Scoped x64 toggle (jax.experimental.enable_x64 was removed)."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _rand64(rng, dtype, n):
    if dtype == np.uint64:
        lo = rng.randint(0, 2**32, size=n, dtype=np.uint64)
        hi = rng.randint(0, 2**32, size=n, dtype=np.uint64)
        return (hi << np.uint64(32)) | lo
    if dtype == np.int64:
        return rng.randint(-2**62, 2**62, size=n).astype(np.int64)
    return (rng.standard_normal(n) * 1e6).astype(np.float64)


@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.float64])
@pytest.mark.parametrize("n", [1024, 20_000])
def test_sort_64bit(rng, dtype, n):
    k = _rand64(rng, dtype, n)
    with enable_x64():
        got = np.asarray(sortx.sort(jnp.asarray(k)))
    assert got.dtype == dtype
    assert np.array_equal(got, np.sort(k))


@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.float64])
def test_sort_64bit_descending(rng, dtype):
    k = _rand64(rng, dtype, 9_999)
    with enable_x64():
        got = np.asarray(sortx.sort(jnp.asarray(k), descending=True))
    assert np.array_equal(got, np.sort(k)[::-1])


def test_sort_f64_special_values(rng):
    # Denormals, infinities, signed zeros: the monotone word transform
    # must reproduce IEEE order exactly (signed zeros compare equal, so
    # numpy's order matches elementwise either way).
    k = np.concatenate([
        np.array([0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324,
                  np.finfo(np.float64).max, np.finfo(np.float64).min]),
        rng.standard_normal(5000) * 1e-300,          # subnormal range
        rng.standard_normal(5000) * 1e300,
    ])
    with enable_x64():
        got = np.asarray(sortx.sort(jnp.asarray(k)))
    assert np.array_equal(got, np.sort(k))


def test_sort_f64_nan_total_order(rng):
    # NaNs order at the extremes by sign bit (the documented monotone
    # transform convention): negative NaNs first, positive NaNs last.
    k = np.concatenate([rng.standard_normal(4000),
                        np.full(7, np.nan), np.full(5, -np.nan)])
    rng.shuffle(k)
    n_neg_nan = int(np.sum(np.signbit(k) & np.isnan(k)))
    n_pos_nan = int(np.sum(~np.signbit(k) & np.isnan(k)))
    with enable_x64():
        got = np.asarray(sortx.sort(jnp.asarray(k)))
    assert np.all(np.isnan(got[:n_neg_nan]))
    assert np.all(np.isnan(got[len(k) - n_pos_nan:]))
    mid = got[n_neg_nan:len(k) - n_pos_nan]
    assert np.array_equal(mid, np.sort(k[~np.isnan(k)]))


def test_sort_kv_64bit_stable(rng):
    n = 30_000
    k = rng.randint(0, 50, size=n).astype(np.uint64)
    v = np.arange(n, dtype=np.uint32)
    with enable_x64():
        ks, vs = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v))
        ks, vs = np.asarray(ks), np.asarray(vs)
    order = np.argsort(k, kind="stable")
    assert ks.dtype == np.uint64
    assert np.array_equal(ks, k[order])
    assert np.array_equal(vs, v[order])


def test_sort_kv_64bit_unstable_valid(rng):
    n = 8192  # power of two exercises the key-only tie_break comparator
    k = rng.randint(0, 40, size=n).astype(np.int64)
    v = np.arange(n, dtype=np.uint32)
    with enable_x64():
        ks, vs = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v),
                               stable=False)
        ks, vs = np.asarray(ks), np.asarray(vs)
    assert np.array_equal(ks, np.sort(k))
    # values must be a permutation consistent with the keys
    assert np.array_equal(np.sort(vs), v)
    assert np.array_equal(k[vs], ks)


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_argsort_64bit_stable(rng, dtype):
    n = 20_000
    if dtype == np.int64:
        k = rng.randint(-30, 30, size=n).astype(np.int64)
    else:
        k = rng.randint(-30, 30, size=n).astype(np.float64)
    with enable_x64():
        perm = np.asarray(sortx.argsort(jnp.asarray(k)))
    assert np.array_equal(perm, np.argsort(k, kind="stable"))


def test_argsort_64bit_descending_stable(rng):
    k = rng.randint(0, 20, size=9_000).astype(np.uint64)
    with enable_x64():
        perm = np.asarray(sortx.argsort(jnp.asarray(k),
                                        descending=True))
    # stable descending: equal keys keep ascending original positions
    exp = np.argsort(-k.astype(np.int64), kind="stable")
    assert np.array_equal(perm, exp)


def _engine_cfg():
    return sortx.Config()


def test_sort_64bit_engine_path(rng):
    n = 8192
    k = _rand64(rng, np.uint64, n)
    v = np.arange(n, dtype=np.uint32)
    cfg = _engine_cfg()
    with enable_x64():
        got = np.asarray(sortx.sort(jnp.asarray(k), config=cfg))
        ks, vs = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v),
                               config=cfg)
    assert np.array_equal(got, np.sort(k))
    order = np.argsort(k, kind="stable")
    assert np.array_equal(np.asarray(ks), k[order])
    assert np.array_equal(np.asarray(vs), v[order])


@pytest.mark.slow
def test_argsort_64bit_engine_path(rng):
    n = 8192
    k = _rand64(rng, np.uint64, n)
    with enable_x64():
        perm = np.asarray(sortx.argsort(jnp.asarray(k),
                                        config=_engine_cfg()))
    assert np.array_equal(perm, np.argsort(k, kind="stable"))


def test_sort_64bit_partial_bits_rejected(rng):
    k = _rand64(rng, np.uint64, 1024)
    with enable_x64():
        ka = jnp.asarray(k)
        with pytest.raises(ValueError, match="full 64"):
            sortx.sort(ka, 32)
        with pytest.raises(ValueError, match="full 64"):
            sortx.sort_kv(ka, jnp.zeros(1024, jnp.uint32), 16)
        # explicit full width is accepted
        got = np.asarray(sortx.sort(ka, 64))
    assert np.array_equal(got, np.sort(k))


def test_sort_64bit_requires_x64():
    # Without x64 there are no 64-bit jax arrays; numpy input downcasts
    # in jnp.asarray, so the 64-bit path simply cannot trigger. Guard
    # the dtype check message instead (f64 via numpy asarray -> f32).
    k = jnp.asarray(np.arange(100, dtype=np.float64))
    assert k.dtype == jnp.float32  # x64 off: silently narrowed by jax
    out = sortx.sort(k)            # sorts fine as f32
    assert out.dtype == jnp.float32


def test_sort_64bit_roundtrip_extremes():
    with enable_x64():
        k = jnp.asarray(np.array(
            [0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1],
            dtype=np.uint64))
        got = np.asarray(sortx.sort(k))
        assert np.array_equal(
            got, np.sort(np.asarray(k)))

        ki = jnp.asarray(np.array(
            [0, -1, 1, -2**63, 2**63 - 1, 2**32, -2**32],
            dtype=np.int64))
        goti = np.asarray(sortx.sort(ki))
        assert np.array_equal(goti, np.sort(np.asarray(ki)))


@pytest.mark.parametrize("vdtype", [np.uint64, np.int64, np.float64])
def test_sort_kv_64bit_values_engine_path(rng, vdtype):
    """64-bit VALUE payloads round-trip exactly (extreme bit patterns
    included) and follow their keys stably."""
    n = 20_000
    keys = rng.randint(0, 64, size=n).astype(np.uint32)  # heavy ties
    vals = _rand64(rng, vdtype, n)
    # plant extreme values to pin exact word round-trips
    if vdtype == np.float64:
        vals[:6] = [0.0, -0.0, np.inf, -np.inf, 5e-324, -1.5]
    else:
        vals[:3] = [0, np.iinfo(vdtype).min, np.iinfo(vdtype).max]
    order = np.argsort(keys, kind="stable")
    with enable_x64():
        ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
        ks, vs = np.asarray(ks), np.asarray(vs)
    assert vs.dtype == vdtype
    assert np.array_equal(ks, keys[order])
    assert np.array_equal(vs.view(np.uint64), vals[order].view(np.uint64))


def test_sort_kv_64bit_values_unstable_engine(rng):
    """Unstable KV with 64-bit values: the result is a valid
    permutation sorted by key."""
    n = 1 << 14
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    vals = _rand64(rng, np.uint64, n)
    with enable_x64():
        ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                               stable=False)
        ks, vs = np.asarray(ks), np.asarray(vs)
    assert np.all(ks[1:] >= ks[:-1])
    got = np.stack([ks.astype(np.uint64), vs], 1)
    exp = np.stack([keys.astype(np.uint64), vals], 1)
    assert np.array_equal(
        got[np.lexsort((got[:, 1], got[:, 0]))],
        exp[np.lexsort((exp[:, 1], exp[:, 0]))])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["v64", "k64"])
def test_x64_large_n_on_gpu(rng, case):
    """Both large-n x64 paths compiled for the card: 64-bit values and
    64-bit keys."""
    n = 1 << 22
    with enable_x64():
        if case == "v64":
            keys = rng.randint(0, 1 << 20, size=n).astype(np.uint32)
            vals = _rand64(rng, np.uint64, n)
            ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
            order = np.argsort(keys, kind="stable")
            assert np.array_equal(np.asarray(ks), keys[order])
            assert np.array_equal(np.asarray(vs), vals[order])
        else:
            k = _rand64(rng, np.uint64, n)
            got = np.asarray(sortx.sort(jnp.asarray(k)))
            assert np.array_equal(got, np.sort(k))
