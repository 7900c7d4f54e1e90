"""Native C++ host sort tests (csrc/host_sort.cpp via ctypes)."""

import numpy as np
import pytest

from sortx.runtime import native

pytestmark = pytest.mark.usefixtures("native_lib")


def test_native_matches_numpy(rng):
    k = rng.randint(0, 2**32, size=123_457, dtype=np.uint32)
    assert np.array_equal(native.host_sort(k), np.sort(k))


def test_native_kv_stability(rng):
    k = rng.randint(0, 32, size=10_000).astype(np.uint32)
    v = np.arange(10_000, dtype=np.uint32)
    ks, vs = native.host_sort_kv(k, v)
    order = np.argsort(k, kind="stable")
    assert np.array_equal(ks, k[order])
    assert np.array_equal(vs, order.astype(np.uint32))


def test_native_partial_bits(rng):
    k = rng.randint(0, 2**32, size=4096, dtype=np.uint32)
    got = native.host_sort(k, 12)
    order = np.argsort(k & 0xFFF, kind="stable")
    assert np.array_equal(got, k[order])


def test_native_scan(rng):
    x = rng.randint(0, 2**32, size=9999, dtype=np.uint32)
    out, total = native.host_scan(x)
    exp = (np.cumsum(x.astype(np.uint64)) - x) & 0xFFFFFFFF
    assert np.array_equal(out, exp.astype(np.uint32))
    assert total == np.uint32(x.astype(np.uint64).sum() & 0xFFFFFFFF)


def test_native_edge_cases():
    assert native.host_sort(np.zeros(0, np.uint32)).shape == (0,)
    assert np.array_equal(native.host_sort(np.array([7], np.uint32)),
                          np.array([7], np.uint32))


def test_native_missing_lib_raises(monkeypatch):
    """ADVICE.md: unbuilt library -> clear RuntimeError, not AttributeError."""
    import pytest

    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="make -C csrc"):
        native.host_sort(np.array([1, 2], np.uint32))
    with pytest.raises(RuntimeError):
        native.host_scan(np.array([1, 2], np.uint32))
