"""Histogram primitive tests (StreamCountKernel-analog public API)."""

import jax.numpy as jnp
import numpy as np
import pytest

import sortx


@pytest.mark.parametrize("bits,shift", [(4, 0), (8, 8), (4, 28), (1, 31),
                                        (8, 28), (8, 25)])
def test_histogram_global(rng, bits, shift):
    # (8, 28) / (8, 25): the digit window hangs past bit 31, so ragged-n
    # padding with 0xFFFFFFFF lands in bucket (0xFFFFFFFF >> shift) &
    # (radix-1), not radix-1 — the round-1 pad-accounting bug (ADVICE.md).
    x = rng.randint(0, 2**32, size=100_003, dtype=np.uint32)
    exp = np.bincount((x >> shift) & ((1 << bits) - 1), minlength=1 << bits)
    got = np.asarray(sortx.histogram(jnp.asarray(x), bits, shift))
    assert np.array_equal(got, exp), (bits, shift)


def test_histogram_per_tile(rng):
    n = 4096 * 4
    x = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    cfg = sortx.Config(sort_tile_elems=4096)
    got = np.asarray(sortx.histogram(jnp.asarray(x), 4, 0, per_tile=True,
                                     config=cfg))
    assert got.shape[0] == 4 and got.sum() == n
    for t in range(4):
        seg = x[t * 4096:(t + 1) * 4096]
        assert np.array_equal(got[t], np.bincount(seg & 15, minlength=16))


def test_histogram_ragged_and_empty(rng):
    for n in (0, 1, 13, 5000):
        x = rng.randint(0, 2**32, size=n, dtype=np.uint32)
        exp = np.bincount(x & 255, minlength=256)
        got = np.asarray(sortx.histogram(jnp.asarray(x), 8, 0))
        assert np.array_equal(got, exp), n


def test_histogram_ragged_high_shift(rng):
    """Ragged n with shift=28, bits=8: the pad lands in no bucket."""
    n = 5000
    x = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    exp = np.bincount((x >> 28) & 255, minlength=256)
    got = np.asarray(sortx.histogram(jnp.asarray(x), 8, 28))
    assert np.array_equal(got, exp)


def test_histogram_validates():
    with pytest.raises(ValueError):
        sortx.histogram(jnp.zeros((4,), jnp.uint32), bits=9)
    with pytest.raises(TypeError):
        sortx.histogram(jnp.zeros((4,), jnp.float32))
