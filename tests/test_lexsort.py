"""lexsort (multi-column stable argsort) vs numpy's np.lexsort.

np.lexsort convention: the LAST key column is the primary sort key.
Covers mixed dtypes, descending, and stability.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sortx


@pytest.mark.parametrize("n", [1, 7, 1000, 4096])
def test_lexsort_two_u32_host(rng, n):
    a = rng.randint(0, 8, size=n).astype(np.uint32)
    b = rng.randint(0, 8, size=n).astype(np.uint32)
    got = np.asarray(sortx.lexsort((jnp.asarray(a), jnp.asarray(b))))
    want = np.lexsort((a, b))
    assert np.array_equal(got, want)


def test_lexsort_engine_path(rng):
    n = 12_288
    a = rng.randint(0, 16, size=n).astype(np.uint32)
    b = rng.randint(0, 16, size=n).astype(np.uint32)
    got = np.asarray(sortx.lexsort((jnp.asarray(a), jnp.asarray(b))))
    want = np.lexsort((a, b))
    assert np.array_equal(got, want)


def test_lexsort_mixed_dtypes(rng):
    n = 5000
    f = rng.randn(n).astype(np.float32)
    i = rng.randint(-50, 50, size=n).astype(np.int32)
    got = np.asarray(sortx.lexsort((jnp.asarray(f), jnp.asarray(i))))
    want = np.lexsort((f, i))
    assert np.array_equal(got, want)


def test_lexsort_16bit_columns(rng):
    n = 3000
    a = rng.randint(0, 2**16, size=n).astype(np.uint16)
    b = rng.randint(-2**15, 2**15, size=n).astype(np.int16)
    got = np.asarray(sortx.lexsort((jnp.asarray(a), jnp.asarray(b))))
    want = np.lexsort((a, b))
    assert np.array_equal(got, want)


def test_lexsort_single_column_is_argsort(rng):
    n = 10_000
    k = rng.randint(0, 100, size=n).astype(np.uint32)
    got = np.asarray(sortx.lexsort((jnp.asarray(k),)))
    assert np.array_equal(got, np.argsort(k, kind="stable"))


def test_lexsort_stability_three_columns(rng):
    n = 8000
    cols = [rng.randint(0, 4, size=n).astype(np.uint32) for _ in range(3)]
    got = np.asarray(sortx.lexsort([jnp.asarray(c) for c in cols]))
    want = np.lexsort(tuple(cols))
    assert np.array_equal(got, want)


def test_lexsort_descending(rng):
    n = 6000
    a = rng.randint(0, 6, size=n).astype(np.uint32)
    b = rng.randint(0, 6, size=n).astype(np.uint32)
    got = np.asarray(sortx.lexsort((jnp.asarray(a), jnp.asarray(b)),
                                   descending=True))
    # stable descending: reverse lex order on keys, ties keep ascending
    # original positions == np.lexsort on complemented columns
    want = np.lexsort((~a, ~b))
    assert np.array_equal(got, want)


def test_lexsort_engine_descending_mixed(rng):
    n = 12_288
    f = rng.randn(n).astype(np.float32)
    u = rng.randint(0, 3, size=n).astype(np.uint32)
    got = np.asarray(sortx.lexsort((jnp.asarray(f), jnp.asarray(u)),
                                   descending=True))
    # build expected via structured sort: primary u desc, then f desc,
    # ties ascending index
    order = np.lexsort((np.arange(n), -f.astype(np.float64),
                        ~u))
    assert np.array_equal(got, order)


def test_lexsort_64bit_column(rng):
    from tests.test_dtypes64 import enable_x64

    n = 4000
    hi = rng.randint(0, 3, size=n).astype(np.uint64) << np.uint64(40)
    lo = rng.randint(0, 5, size=n).astype(np.uint64)
    k64 = hi | lo
    k32 = rng.randint(0, 4, size=n).astype(np.uint32)
    with enable_x64():
        got = np.asarray(sortx.lexsort(
            (jnp.asarray(k32), jnp.asarray(k64))))
    want = np.lexsort((k32, k64))
    assert np.array_equal(got, want)


def test_lexsort_validation():
    a = jnp.zeros((4,), jnp.uint32)
    with pytest.raises(ValueError):
        sortx.lexsort(())
    with pytest.raises(ValueError):
        sortx.lexsort((a, jnp.zeros((5,), jnp.uint32)))
    with pytest.raises(ValueError):
        sortx.lexsort((jnp.zeros((2, 2), jnp.uint32),))
    with pytest.raises(TypeError):
        sortx.lexsort((jnp.zeros((4,), jnp.uint8),))
