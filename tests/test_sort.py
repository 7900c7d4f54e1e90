"""Keys-only sort tests: Demo.Sort32 analog (UnitTest/main.cpp:88-141)."""

import jax.numpy as jnp
import numpy as np
import pytest

import sortx
from sortx import reference
from tests.conftest import sweep_sizes


@pytest.mark.parametrize("n", sweep_sizes())
def test_sort32_sweep(rng, n):
    # Keys uniform in [0, 0xffffffff] (UnitTest/main.cpp:122).
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    golden = reference.radix_sort(keys)
    got = np.asarray(sortx.sort(jnp.asarray(keys)))
    assert np.array_equal(got, golden), n


def test_sort_ragged_sizes(rng):
    """No n%256 requirement (the reference asserts it, Pprims.cpp:327)."""
    for n in (1, 2, 13, 255, 257, 1000, 65537):
        keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
        golden = reference.radix_sort(keys)
        got = np.asarray(sortx.sort(jnp.asarray(keys)))
        assert np.array_equal(got, golden), n


@pytest.mark.parametrize("sort_bits", [4, 8, 12, 16, 28, 32])
def test_sort_partial_bits(rng, sort_bits):
    """sortBits contract: order by low bits only, stable (Pprims.cpp:253)."""
    keys = rng.randint(0, 2**32, size=10_000, dtype=np.uint32)
    golden = reference.radix_sort(keys, sort_bits=sort_bits)
    got = np.asarray(sortx.sort(jnp.asarray(keys), sort_bits))
    assert np.array_equal(got, golden), sort_bits


def test_sort_skewed_distributions(rng):
    """Skew cases from BASELINE.json: all-equal and one-hot-bucket keys."""
    for keys in (
        np.full(100_000, 0xDEADBEEF, dtype=np.uint32),          # all equal
        np.zeros(65_536, dtype=np.uint32),                       # all zero
        (rng.randint(0, 2, size=100_000) * 0x80000000).astype(np.uint32),
        np.sort(rng.randint(0, 2**32, size=65_536, dtype=np.uint32)),
        np.sort(rng.randint(0, 2**32, size=65_536, dtype=np.uint32))[::-1].copy(),
    ):
        golden = reference.radix_sort(keys)
        got = np.asarray(sortx.sort(jnp.asarray(keys)))
        assert np.array_equal(got, golden)


def test_sort_int32_natural_order(rng):
    """int32 keys sort in natural signed order (beyond-reference)."""
    keys = rng.randint(-2**31, 2**31, size=4096).astype(np.int32)
    got = np.asarray(sortx.sort(jnp.asarray(keys)))
    assert np.array_equal(got, np.sort(keys))


def test_sort_float32_order(rng):
    """float32 keys sort in float order incl. negatives, zeros, infs."""
    keys = np.concatenate([
        rng.randn(4000).astype(np.float32) * 1e5,
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40], np.float32),
    ])
    got = np.asarray(sortx.sort(jnp.asarray(keys)))
    assert np.array_equal(got, np.sort(keys))


def test_sort_float32_kv_stability(rng):
    keys = rng.randint(0, 8, size=10_000).astype(np.float32)
    vals = np.arange(10_000, dtype=np.uint32)
    order = np.argsort(keys, kind="stable")
    ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    assert np.array_equal(np.asarray(ks), keys[order])
    assert np.array_equal(np.asarray(vs), order.astype(np.uint32))


def test_sort_validates_args():
    with pytest.raises(TypeError):
        sortx.sort(jnp.zeros((8,), jnp.uint8))
    with pytest.raises(ValueError):
        sortx.sort(jnp.zeros((8,), jnp.uint32), sort_bits=0)
    with pytest.raises(ValueError):
        sortx.sort(jnp.zeros((8,), jnp.uint32), sort_bits=33)
    with pytest.raises(ValueError):
        # partial bits only defined for u32 (reference contract)
        sortx.sort(jnp.zeros((8,), jnp.int32), sort_bits=8)


def test_argsort_stable(rng):
    keys = rng.randint(0, 16, size=20_000).astype(np.uint32)
    perm = np.asarray(sortx.argsort(jnp.asarray(keys)))
    assert np.array_equal(perm, np.argsort(keys, kind="stable"))


def test_argsort_float(rng):
    keys = rng.randn(5000).astype(np.float32)
    perm = np.asarray(sortx.argsort(jnp.asarray(keys)))
    assert np.array_equal(keys[perm], np.sort(keys))


def test_argsort_engine_two_stream(rng):
    """argsort as a (masked key, idx) sort — stable, partial bits,
    presorted identity, float keys."""
    n = 12_288
    keys = rng.randint(0, 16, size=n).astype(np.uint32)
    perm = np.asarray(sortx.argsort(jnp.asarray(keys)))
    assert np.array_equal(perm, np.argsort(keys, kind="stable"))

    ku = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    perm = np.asarray(sortx.argsort(jnp.asarray(ku), 8))
    assert np.array_equal(perm, np.argsort(ku & 255, kind="stable"))

    pre = np.sort(ku)
    perm = np.asarray(sortx.argsort(jnp.asarray(pre)))
    assert np.array_equal(perm, np.arange(n))

    f = rng.randn(n).astype(np.float32)
    perm = np.asarray(sortx.argsort(jnp.asarray(f)))
    assert np.array_equal(perm, np.argsort(f, kind="stable"))


def test_sort_u64(rng):
    n = 30_000
    hi = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    lo = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    shi, slo = sortx.sort_u64(jnp.asarray(hi), jnp.asarray(lo))
    full = (hi.astype(np.uint64) << 32) | lo
    exp = np.sort(full)
    got = (np.asarray(shi).astype(np.uint64) << 32) | np.asarray(slo)
    assert np.array_equal(got, exp)


def test_sort_kv_u64_stability(rng):
    n = 20_000
    hi = rng.randint(0, 4, size=n).astype(np.uint32)
    lo = rng.randint(0, 4, size=n).astype(np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    shi, slo, svals = sortx.sort_kv_u64(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals))
    full = (hi.astype(np.uint64) << 32) | lo
    order = np.argsort(full, kind="stable")
    assert np.array_equal(np.asarray(shi), hi[order])
    assert np.array_equal(np.asarray(slo), lo[order])
    assert np.array_equal(np.asarray(svals), vals[order])


def test_sort_reverse_sorted_fast_path(rng):
    """Descending inputs (with ties) flip via the adaptive path."""
    base = np.sort(rng.randint(0, 64, size=50_000).astype(np.uint32))
    desc = base[::-1].copy()
    got = np.asarray(sortx.sort(jnp.asarray(desc)))
    assert np.array_equal(got, base)


def test_sort_u64_validates_dtype():
    """ADVICE.md: i32 halves would sort per-word in signed order — reject."""
    with pytest.raises(TypeError):
        sortx.sort_u64(jnp.zeros((8,), jnp.int32), jnp.zeros((8,), jnp.int32))


@pytest.mark.parametrize("sort_bits", [8, 19, 20])
def test_partial_bits_packed_tiebreak_engine(rng, sort_bits):
    """Partial sort_bits around the 32-bit boundary of sort_bits +
    log2(n) (n=8192): the masked-key sort must stay stable and match
    the golden oracle bit-for-bit."""
    n = 8192                          # pow2: exercises the no-pad edge
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    golden = reference.radix_sort(keys, sort_bits)
    got = np.asarray(sortx.sort(jnp.asarray(keys), sort_bits))
    assert np.array_equal(got, golden)


def test_partial_bits_packed_kv_all_masked_equal(rng):
    """Adversarial partial-bits case: every masked key equal AND at the
    mask maximum, pow2 n. Stability must equal input order; values
    follow."""
    n = 4096
    sort_bits = 6
    keys = (rng.randint(0, 2**26, size=n).astype(np.uint32) << 6) \
        | np.uint32(63)
    vals = np.arange(n, dtype=np.uint32)
    gk, gv = reference.radix_sort_kv(keys, vals, sort_bits)
    ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                           sort_bits)
    assert np.array_equal(np.asarray(ks), gk)
    assert np.array_equal(np.asarray(vs), gv)


_DTYPES = [np.uint32, np.int32, np.float32, np.uint16, np.int16,
           np.float16, "bfloat16"]


def _keys_of(rng, dtype, n):
    """Duplicate-heavy keys of ``dtype`` (ties make stability visible)."""
    if dtype == "bfloat16":
        return jnp.asarray(rng.randint(-40, 40, size=n) / 4.0,
                           jnp.bfloat16)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return jnp.asarray((rng.randint(-40, 40, size=n) / 4.0).astype(dt))
    info = np.iinfo(dt)
    lo, hi = max(int(info.min), -1000), min(int(info.max), 1000)
    return jnp.asarray(rng.randint(lo, hi, size=n).astype(dt))


@pytest.mark.parametrize("n", [1000, 4097])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_sort_kv_xla_path_matrix(rng, dtype, descending, n):
    """The XLA path over dtype x descending x ragged n: keys match
    numpy's order, and values follow stably (stable and unstable
    requests both get the stable answer)."""
    keys = _keys_of(rng, dtype, n)
    k64 = np.asarray(keys.astype(jnp.float32), np.float64)
    order = np.argsort(-k64 if descending else k64, kind="stable")
    got = np.asarray(sortx.sort(keys, descending=descending)
                     .astype(jnp.float32))
    np.testing.assert_array_equal(got, k64[order])
    vals = jnp.arange(n, dtype=jnp.int32)
    for stable in (True, False):
        ks, vs = sortx.sort_kv(keys, vals, stable=stable,
                               descending=descending)
        assert ks.dtype == keys.dtype
        np.testing.assert_array_equal(np.asarray(vs), order)
