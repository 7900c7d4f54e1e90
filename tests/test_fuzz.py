"""Differential fuzzing vs the golden oracle.

Randomized shapes/distributions, all compared bit-exactly.
Seeded deterministically per case (reference style: fixed seeds).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sortx
from sortx import reference


def _dist(rng, kind, n):
    if kind == "uniform":
        return rng.randint(0, 2**32, size=n, dtype=np.uint32)
    if kind == "low":
        return rng.randint(0, 7, size=n).astype(np.uint32)
    if kind == "bytes":
        return (rng.randint(0, 2**32, size=n, dtype=np.uint32)
                & np.uint32(0xFF00FF00))
    if kind == "runs":  # long sorted runs with jumps
        x = np.cumsum(rng.randint(0, 3, size=n)).astype(np.uint32)
        x[rng.randint(0, n, size=max(1, n // 50))] = 0xFFFFFFFE
        return x
    if kind == "extremes":
        pool = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                         0xFFFFFFFF], np.uint32)
        return pool[rng.randint(0, len(pool), size=n)]
    raise ValueError(kind)


DISTS = ["uniform", "low", "bytes", "runs", "extremes"]


@pytest.mark.parametrize("case", range(20))
def test_fuzz_sort(case):
    rng = np.random.RandomState(1000 + case)
    n = int(rng.randint(1, 50_000))
    kind = DISTS[case % len(DISTS)]
    keys = _dist(rng, kind, n)
    bits = int(rng.choice([32, 32, 32, 4, 8, 17, 31]))
    golden = reference.radix_sort(keys, bits)
    got = np.asarray(sortx.sort(jnp.asarray(keys), bits))
    assert np.array_equal(got, golden), (case, kind, n, bits)


@pytest.mark.parametrize("case", range(12))
def test_fuzz_sort_kv(case):
    rng = np.random.RandomState(2000 + case)
    n = int(rng.randint(1, 30_000))
    kind = DISTS[case % len(DISTS)]
    keys = _dist(rng, kind, n)
    vals = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    gk, gv = reference.radix_sort_kv(keys, vals)
    ks, vs = sortx.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    assert np.array_equal(np.asarray(ks), gk), (case, kind, n)
    assert np.array_equal(np.asarray(vs), gv), (case, kind, n)


@pytest.mark.parametrize("case", range(8))
def test_fuzz_sort_rows(case):
    rng = np.random.RandomState(4000 + case)
    B = int(rng.randint(1, 64))
    L = int(rng.randint(2, 4000))
    kind = DISTS[case % len(DISTS)]
    keys = _dist(rng, kind, B * L).reshape(B, L)
    got = np.asarray(sortx.sort_rows(jnp.asarray(keys)))
    assert np.array_equal(got, np.sort(keys, axis=1)), (case, kind, B, L)
    vals = np.tile(np.arange(L, dtype=np.uint32), (B, 1))
    ks, vs = sortx.sort_kv_rows(jnp.asarray(keys), jnp.asarray(vals))
    order = np.argsort(keys, axis=1, kind="stable")
    assert np.array_equal(np.asarray(ks),
                          np.take_along_axis(keys, order, 1))
    assert np.array_equal(np.asarray(vs),
                          np.take_along_axis(vals, order, 1))


@pytest.mark.parametrize("case", range(12))
def test_fuzz_scan(case):
    rng = np.random.RandomState(3000 + case)
    n = int(rng.randint(1, 200_000))
    # include values that overflow int32 sums (wraparound must be exact)
    x = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    exp, exp_total = reference.exclusive_scan(x, with_total=True)
    got, total = sortx.scan(jnp.asarray(x), with_total=True)
    assert np.array_equal(np.asarray(got), exp), (case, n)
    assert np.uint32(np.asarray(total)) == exp_total


@pytest.mark.parametrize("case", range(10))
def test_fuzz_merge(case):
    rng = np.random.RandomState(5000 + case)
    na = int(rng.randint(1, 40_000))
    nb = int(rng.randint(1, 40_000))
    kind = DISTS[case % len(DISTS)]
    a = np.sort(_dist(rng, kind, na))
    b = np.sort(_dist(rng, kind, nb))
    got = np.asarray(sortx.merge(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, np.sort(np.concatenate([a, b]))), (
        case, kind, na, nb)
    # KV with std::merge tie semantics (a first, input order kept)
    va = np.arange(na, dtype=np.uint32)
    vb = np.arange(nb, dtype=np.uint32) | np.uint32(1 << 31)
    ks, vs = sortx.merge_kv(jnp.asarray(a), jnp.asarray(va),
                            jnp.asarray(b), jnp.asarray(vb))
    order = np.argsort(np.concatenate([a, b]), kind="stable")
    assert np.array_equal(np.asarray(ks),
                          np.concatenate([a, b])[order])
    assert np.array_equal(np.asarray(vs),
                          np.concatenate([va, vb])[order])


@pytest.mark.parametrize("case", range(8))
def test_fuzz_scan_segments(case):
    rng = np.random.RandomState(6000 + case)
    n = int(rng.randint(1, 16_000))
    n_seg = int(rng.randint(1, 200))
    cuts = np.sort(rng.randint(0, n + 1, size=n_seg - 1))
    off = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    x = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    got, tot = sortx.scan_segments(jnp.asarray(x), jnp.asarray(off),
                                   with_totals=True)
    exp = np.zeros_like(x)
    etot = np.zeros(len(off) - 1, np.uint32)
    for i in range(len(off) - 1):
        seg = x[off[i]:off[i + 1]].astype(np.uint64)
        c = np.cumsum(seg) & 0xFFFFFFFF
        exp[off[i]:off[i + 1]] = (c - seg).astype(np.uint32)
        etot[i] = np.uint32(c[-1]) if len(seg) else 0
    assert np.array_equal(np.asarray(got), exp), (case, n, n_seg)
    assert np.array_equal(np.asarray(tot), etot), (case, n, n_seg)


@pytest.mark.parametrize("case", range(8))
def test_fuzz_unique(case):
    rng = np.random.RandomState(7000 + case)
    n = int(rng.randint(1, 60_000))
    kind = DISTS[case % len(DISTS)]
    x = _dist(rng, kind, n)
    size = int(rng.randint(1, 3000))
    vals, counts, nu = sortx.unique(jnp.asarray(x), size)
    ev, ec = np.unique(x, return_counts=True)
    k = min(len(ev), size)
    assert int(nu) == len(ev), (case, kind, n, size)
    assert np.array_equal(np.asarray(vals)[:k], ev[:k])
    assert np.array_equal(np.asarray(counts)[:k], ec[:k])
