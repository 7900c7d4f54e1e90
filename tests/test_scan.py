"""Scan tests: Demo.Scan analog (UnitTest/main.cpp:172-213) + the 2^20 fix.

The reference FAILS at n=1024K (``Pprims.cpp:134-138`` hard cap); the
1024K (and larger) cases here are the regression tests proving we
out-scaled it. The Triton kernel (``ops/scan.py``) runs here in
interpret mode, called directly; the public API runs it only on a GPU.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

import sortx
from sortx import reference
from tests.conftest import sweep_sizes

# Triton-kernel sweep sizes (interpret mode is orders of magnitude
# slower than the card, so these stay small).
PALLAS_SIZES = [1024, 4096, 100_000]

# The module, not the ``scan`` function that ``sortx.ops`` re-exports.
scan_mod = importlib.import_module("sortx.ops.scan")


def _triton(x, inclusive=False, block=1024):
    """The Triton scan in interpret mode; (scanned, total) as numpy."""
    xi = jnp.asarray(x)
    xi = xi.view(jnp.int32) if xi.dtype == jnp.uint32 else xi
    out, total = scan_mod._scan_triton(xi, inclusive=inclusive,
                                       block=block, interpret=True)
    dt = np.asarray(x).dtype
    return np.asarray(out).view(dt), np.asarray(total).view(dt)


@pytest.mark.parametrize("n", sweep_sizes())
def test_scan_host_engine_sweep(rng, n):
    x = rng.randint(0, 16, size=n).astype(np.int32)  # main.cpp:183 range
    got, _ = scan_mod._scan_cumsum(jnp.asarray(x), inclusive=False)
    assert np.array_equal(np.asarray(got), reference.exclusive_scan(x))


@pytest.mark.parametrize("n", PALLAS_SIZES)
def test_scan_pallas_sweep(rng, n):
    x = rng.randint(0, 16, size=n).astype(np.int32)
    got, total = _triton(x)
    exp, exp_total = reference.exclusive_scan(x, with_total=True)
    np.testing.assert_array_equal(got, exp)
    assert np.uint32(total) == exp_total


def test_scan_1024k_passes(rng):
    """THE reference bug: n = 4096*256 = 2^20 returns garbage there."""
    n = 1 << 20
    x = rng.randint(0, 16, size=n).astype(np.int32)
    got = np.asarray(sortx.scan(jnp.asarray(x)))
    assert np.array_equal(got, reference.exclusive_scan(x))
    got, _ = _triton(x, block=1 << 14)
    assert np.array_equal(got, reference.exclusive_scan(x))


def test_scan_u32_wraparound(rng):
    x = rng.randint(0, 2**32, size=4096, dtype=np.uint32)
    got, _ = _triton(x)
    assert got.dtype == np.uint32
    assert np.array_equal(got, reference.exclusive_scan(x))
    got = np.asarray(sortx.scan(jnp.asarray(x)))
    assert got.dtype == np.uint32
    assert np.array_equal(got, reference.exclusive_scan(x))


def test_scan_ragged_sizes(rng):
    for n in (1, 13, 127, 129, 1025, 40_000 + 7):
        x = rng.randint(0, 100, size=n).astype(np.int32)
        got, _ = _triton(x)
        assert np.array_equal(got, reference.exclusive_scan(x)), n
        got = np.asarray(sortx.scan(jnp.asarray(x)))
        assert np.array_equal(got, reference.exclusive_scan(x)), n


def test_scan_empty():
    x = jnp.zeros((0,), jnp.int32)
    out, total = sortx.scan(x, with_total=True)
    assert out.shape == (0,)
    assert int(total) == 0


def test_scan_rejects_bad_input():
    with pytest.raises(TypeError):
        sortx.scan(jnp.zeros((8,), jnp.float32))
    with pytest.raises(ValueError):
        sortx.scan(jnp.zeros((8, 8), jnp.int32))


def test_scan_inclusive(rng):
    x = rng.randint(0, 100, size=5000).astype(np.int32)
    got, _ = _triton(x, inclusive=True)
    assert np.array_equal(got, np.cumsum(x).astype(np.int32))
    got_h, _ = scan_mod._scan_cumsum(jnp.asarray(x), inclusive=True)
    assert np.array_equal(np.asarray(got_h), np.cumsum(x).astype(np.int32))


def test_sortx_assert_debug_mode():
    from sortx.utils import SortxError, set_debug, sortx_assert
    set_debug(False)
    sortx_assert(False, "ignored in release")  # no-op
    set_debug(True)
    try:
        sortx_assert(1 + 1 == 2, "fine")
        import pytest as _pt
        with _pt.raises(SortxError):
            sortx_assert(False, "boom")
    finally:
        set_debug(False)


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 3 * 1024 + 5])
@pytest.mark.parametrize("inclusive", [False, True])
def test_scan_triton_padding_and_tails(rng, n, inclusive):
    """The kernel's wrapper pads n up to whole blocks with zeros and
    slices back: ragged tails (one element past a block, one short,
    a single element) give the exact wrapped sums and total."""
    x = rng.randint(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
    got, total = _triton(x, inclusive=inclusive)
    u = x.view(np.uint32).astype(np.uint64)
    incl = (np.cumsum(u) & 0xFFFFFFFF).astype(np.uint32)
    exp = incl if inclusive else incl - x.view(np.uint32)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got.view(np.uint32), exp)
    assert np.uint32(total.view(np.uint32)) == incl[-1]


def test_scan_triton_under_x64(rng):
    """x64 mode (needed for 64-bit keys elsewhere) must not widen the
    kernel's int32 arithmetic or its total."""
    import jax

    x = rng.randint(0, 2**32, size=3000, dtype=np.uint32)
    with jax.enable_x64(True):
        got, total = _triton(x)
    exp, exp_total = reference.exclusive_scan(x, with_total=True)
    assert got.dtype == np.uint32 and total.dtype == np.uint32
    np.testing.assert_array_equal(got, exp)
    assert np.uint32(total) == exp_total


@pytest.mark.parametrize("block", [1024, 2048, 8192])
def test_scan_triton_block_sizes_agree(rng, block):
    """Every power-of-two block gives the same answer, including one
    larger than n (a single padded block)."""
    x = rng.randint(0, 2**32, size=5000, dtype=np.uint32)
    got, total = _triton(x, block=block)
    exp, exp_total = reference.exclusive_scan(x, with_total=True)
    np.testing.assert_array_equal(got, exp)
    assert np.uint32(total) == exp_total


def test_scan_triton_block_fills_the_card():
    """The tuned block is a power of two and leaves several blocks per
    SM at the smallest n the kernel is dispatched for."""
    from sortx.ops.dispatch import TRITON_SCAN_MIN_N

    b = scan_mod._BLOCK
    assert b & (b - 1) == 0
    assert TRITON_SCAN_MIN_N // b >= 4 * 132


def test_scan_dispatch_uses_cumsum_off_gpu(rng, monkeypatch):
    """Off the GPU the public scan never reaches the kernel."""
    def boom(*a, **k):
        raise AssertionError("Triton kernel reached off the GPU")

    monkeypatch.setattr(scan_mod, "_scan_triton", boom)
    x = rng.randint(0, 16, size=(1 << 20) + 3).astype(np.int32)
    got = np.asarray(sortx.scan(jnp.asarray(x)))
    assert np.array_equal(got, reference.exclusive_scan(x))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 24, (1 << 24) + 13])
def test_scan_triton_on_gpu(rng, n):
    """The compiled kernel on the card, through the public API."""
    from sortx.ops.dispatch import resolve

    assert resolve("scan", sortx.Config(), n) == "triton"
    x = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    got, total = sortx.scan(jnp.asarray(x), with_total=True)
    exp, exp_total = reference.exclusive_scan(x, with_total=True)
    np.testing.assert_array_equal(np.asarray(got), exp)
    assert np.uint32(np.asarray(total)) == exp_total
