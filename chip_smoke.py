"""Smoke test of sortx on the GPU, bit-exact against numpy.

    python chip_smoke.py             one card: phases 1, 2 and 3
    python chip_smoke.py --chips 4   four cards: the distributed phase only

Phase 1 runs the main path (sort, sort_kv, scan) at 2^27 elements; phase
2 times the Triton scan kernel against ``jnp.cumsum`` at 2^27, 2^24 (the
smallest n ``sortx.scan`` sends to the kernel) and 2^20;
phase 3 calls every public op once at 2^22. With ``--chips 4`` the
distributed sort and scan run at 2^27 keys per card instead.

Each check prints PASS or FAIL. Times printed beside them are
informational, not the benchmark. The script exits nonzero if a check
fails, if JAX finds no GPU, or if sortx cannot be imported; only a run
whose every check passed prints, as its last line, one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import importlib
import json
import subprocess
import sys
import time

import numpy as np


def card_info() -> str:
    """nvidia-smi's name and power limit of each card, read by a child
    process that stays off JAX."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return (r.stdout or r.stderr).strip()


class Checks:
    """PASS/FAIL bookkeeping; an exception inside a check is a FAIL."""

    def __init__(self, card: str = "unknown card"):
        self.card = card
        self.failed: list[str] = []
        self.passed = 0

    def check(self, name: str, fn) -> bool:
        try:
            ok, detail = fn()
        except Exception as e:  # recorded as a FAIL; the run exits nonzero
            ok, detail = False, f"{type(e).__name__}: {e}"[:600]
        print(f"{'PASS' if ok else 'FAIL'} {name}"
              + (f"  [{detail}]" if detail else ""), flush=True)
        if ok:
            self.passed += 1
        else:
            self.failed.append(name)
        return ok

    def timing(self, tc: float, tw: float, peak) -> str:
        return (f"compile {tc:.2f} s (set-up); warm {tw * 1e3:.3f} ms on "
                f"{self.card} (informational, not the benchmark); "
                f"peak_bytes_in_use {peak}")


def preflight():
    """Print the JAX versions and devices; refuse a non-GPU platform by
    exiting nonzero."""
    import jax
    import jaxlib

    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}", flush=True)
    devs = jax.devices()
    print(f"devices {devs}", flush=True)
    if devs[0].platform != "gpu":
        print(f"FAIL preflight: JAX platform is {devs[0].platform!r}, "
              f"not 'gpu'", flush=True)
        sys.exit(2)
    return devs


def _peak():
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use",
                                                       "n/a")


def _timed(fn, *args):
    """Compile ``fn`` for ``args`` (set-up), run it, then time one warm
    call to ``block_until_ready``. Returns (out, compile_s, warm_s)."""
    import jax

    t0 = time.perf_counter()
    c = jax.jit(fn).lower(*args).compile()
    tc = time.perf_counter() - t0
    jax.block_until_ready(c(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(c(*args))
    return out, tc, time.perf_counter() - t0


def _np_scan(x_u32, inclusive: bool):
    incl = (np.cumsum(x_u32, dtype=np.uint64) & 0xFFFFFFFF).astype(np.uint32)
    return incl if inclusive else incl - x_u32


def _stable_certificate(keys, out_keys, perm) -> bool:
    """True iff ``perm`` is THE stable sorting permutation of ``keys``
    and ``out_keys == keys[perm]``: a permutation, sorted, and
    increasing within every run of equal keys — O(n) numpy work."""
    n = keys.shape[0]
    perm = perm.astype(np.int64)
    if perm.shape != (n,) or not np.all(np.bincount(perm, minlength=n) == 1):
        return False
    if not np.array_equal(keys[perm], out_keys):
        return False
    if not np.all(out_keys[1:] >= out_keys[:-1]):
        return False
    return bool(np.all((out_keys[1:] != out_keys[:-1])
                       | (perm[1:] > perm[:-1])))


# ---------------------------------------------------------------------
# Phase 1: the main path.

def phase_main(ch: Checks, n: int = 1 << 27, seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp

    import sortx

    print(f"== phase 1: main path at n={n}", flush=True)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    keys = jax.random.bits(k1, (n,), jnp.uint32)
    kn = np.asarray(keys)
    srt = np.sort(kn)

    def sort_full():
        out, tc, tw = _timed(sortx.sort, keys)
        return np.array_equal(np.asarray(out), srt), ch.timing(tc, tw,
                                                               _peak())

    def sort_ragged():
        kr = keys[:n - 13]
        out, tc, tw = _timed(sortx.sort, kr)
        return (np.array_equal(np.asarray(out), np.sort(kn[:n - 13])),
                ch.timing(tc, tw, _peak()))

    vals = jnp.arange(n, dtype=jnp.uint32)
    perm = np.argsort(kn, kind="stable")

    def sort_kv_stable():
        (ks, vs), tc, tw = _timed(sortx.sort_kv, keys, vals)
        ok = (np.array_equal(np.asarray(ks), srt)
              and np.array_equal(np.asarray(vs), perm))
        return ok, ch.timing(tc, tw, _peak())

    def sort_kv_unstable():
        (ks, vs), tc, tw = _timed(
            lambda k, v: sortx.sort_kv(k, v, stable=False), keys, vals)
        ks, vs = np.asarray(ks), np.asarray(vs).astype(np.int64)
        ok = (np.array_equal(ks, srt)
              and np.all(np.bincount(vs, minlength=n) == 1)
              and np.array_equal(kn[vs], ks))
        return ok, ch.timing(tc, tw, _peak())

    x = jax.random.bits(k2, (n,), jnp.uint32).view(jnp.int32)
    xu = np.asarray(x).view(np.uint32)
    excl, incl = _np_scan(xu, False), _np_scan(xu, True)

    def scan_excl_total():
        (s, t), tc, tw = _timed(
            lambda a: sortx.scan(a, with_total=True), x)
        ok = (np.array_equal(np.asarray(s).view(np.uint32), excl)
              and np.uint32(np.asarray(t).view(np.uint32)) == incl[-1])
        return ok, ch.timing(tc, tw, _peak())

    def scan_incl():
        s, tc, tw = _timed(lambda a: sortx.scan(a, inclusive=True), x)
        return (np.array_equal(np.asarray(s).view(np.uint32), incl),
                ch.timing(tc, tw, _peak()))

    def scan_ragged():
        s, tc, tw = _timed(sortx.scan, x[:n - 13])
        return (np.array_equal(np.asarray(s).view(np.uint32),
                               _np_scan(xu[:n - 13], False)),
                ch.timing(tc, tw, _peak()))

    ch.check(f"sort u32 uniform n={n}", sort_full)
    ch.check(f"sort u32 ragged n={n - 13}", sort_ragged)
    ch.check(f"sort_kv stable u32/arange n={n}", sort_kv_stable)
    ch.check(f"sort_kv(stable=False) multiset n={n}", sort_kv_unstable)
    ch.check(f"scan exclusive+total int32 n={n}", scan_excl_total)
    ch.check(f"scan inclusive int32 n={n}", scan_incl)
    ch.check(f"scan exclusive ragged n={n - 13}", scan_ragged)


# ---------------------------------------------------------------------
# Phase 2: the scan kernel against jnp.cumsum.

def phase_scan_kernel(ch: Checks, sizes=(1 << 27, 1 << 24, 1 << 20),
                      seed: int = 1,
                      reps: int = 30, interpret: bool = False) -> dict:
    import jax
    import jax.numpy as jnp

    scan_mod = importlib.import_module("sortx.ops.scan")
    print(f"== phase 2: Triton scan kernel vs jnp.cumsum at {sizes}",
          flush=True)
    kernel = jax.jit(lambda a: scan_mod._scan_triton(
        a, inclusive=False, interpret=interpret)[0])
    cumsum = jax.jit(lambda a: scan_mod._scan_cumsum(a, inclusive=False)[0])
    medians = {}
    for n in sizes:
        x = jax.random.bits(jax.random.PRNGKey(seed), (n,),
                            jnp.uint32).view(jnp.int32)
        exp = _np_scan(np.asarray(x).view(np.uint32), False)
        for name, f in (("triton", kernel), ("cumsum", cumsum)):
            ch.check(f"scan {name} n={n}", lambda f=f: (np.array_equal(
                np.asarray(jax.block_until_ready(f(x))).view(np.uint32),
                exp), ""))
        times = {"triton": [], "cumsum": []}
        for _ in range(reps):          # alternate, so drift hits both
            for name, f in (("triton", kernel), ("cumsum", cumsum)):
                t0 = time.perf_counter()
                jax.block_until_ready(f(x))
                times[name].append(time.perf_counter() - t0)
        med = {k: float(np.median(v)) for k, v in times.items()}
        medians[n] = med
        print(f"TIME scan n={n}: triton median {med['triton'] * 1e3:.4f} ms "
              f"(min {min(times['triton']) * 1e3:.4f}), cumsum median "
              f"{med['cumsum'] * 1e3:.4f} ms (min "
              f"{min(times['cumsum']) * 1e3:.4f}), {reps} calls each, "
              f"{ch.card} (informational)", flush=True)
    from sortx.ops.dispatch import TRITON_SCAN_MIN_N

    for n, m in medians.items():
        print(f"VERDICT scan n={n}: kernel "
              f"{'faster' if m['triton'] < m['cumsum'] else 'NOT faster'}"
              f" than jnp.cumsum; sortx.scan dispatches it for n >= "
              f"{TRITON_SCAN_MIN_N}", flush=True)
    return medians


# ---------------------------------------------------------------------
# Phase 3: every public op once.

def _radix_np(a: np.ndarray) -> np.ndarray:
    """numpy image of sortx's total order: unsigned keys whose order is
    the sort order (floats: -NaN < -inf < ... < -0.0 < +0.0 < ... <
    +inf < +NaN)."""
    if a.dtype.kind == "u":
        return a
    if a.dtype.kind == "i":
        u = a.view(a.dtype.str.replace("i", "u"))
        return u ^ u.dtype.type(1 << (8 * a.dtype.itemsize - 1))
    u = a.view(a.dtype.str.replace("f", "u"))
    top = u.dtype.type(1 << (8 * a.dtype.itemsize - 1))
    return u ^ np.where(u >= top, u.dtype.type(~u.dtype.type(0)), top)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def phase_surface(ch: Checks, n: int = 1 << 22, rows_shape=(2048, 65536),
                  seed: int = 2) -> None:
    import jax
    import jax.numpy as jnp

    import sortx
    from sortx import reference

    print(f"== phase 3: public surface at n={n}", flush=True)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    dup = rng.integers(0, 64, size=n).astype(np.uint32)
    ju, jdup = jnp.asarray(u), jnp.asarray(dup)
    stable = np.argsort(dup, kind="stable")

    def by_order(a):
        return a[np.argsort(_radix_np(a), kind="stable")]

    f32 = rng.standard_normal(n).astype(np.float32)
    f32[:6] = [np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf]
    inputs = {
        "int32": rng.integers(-2**31, 2**31, size=n).astype(np.int32),
        "float32 (NaN, -0.0)": f32,
        "uint16": rng.integers(0, 2**16, size=n).astype(np.uint16),
    }
    for name, a in inputs.items():
        ch.check(f"sort {name}", lambda a=a: (_same_bits(
            sortx.sort(jnp.asarray(a)), by_order(a)), ""))
    bf = jnp.asarray(rng.standard_normal(n), jnp.bfloat16)

    def sort_bf16():
        got = np.asarray(sortx.sort(bf).astype(jnp.float32))
        exp = by_order(np.asarray(bf.astype(jnp.float32)))
        return _same_bits(got, exp), ""

    ch.check("sort bfloat16", sort_bf16)

    with jax.enable_x64(True):
        f64 = rng.standard_normal(n)
        f64[:6] = [np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf]
        wide = {"uint64": rng.integers(0, 2**64, size=n, dtype=np.uint64),
                "int64": rng.integers(-2**63, 2**63, size=n, dtype=np.int64),
                "float64 (NaN, -0.0)": f64}
        for name, a in wide.items():
            ch.check(f"sort {name} (x64)", lambda a=a: (_same_bits(
                sortx.sort(jnp.asarray(a)), by_order(a)), ""))
        v64 = wide["uint64"]
        ch.check("sort_kv u32 keys, u64 values (x64)", lambda: (
            _same_bits(sortx.sort_kv(jdup, jnp.asarray(v64))[1],
                       v64[stable]), ""))
        c0 = rng.integers(0, 4, size=n).astype(np.uint32)
        c1 = rng.integers(-3, 3, size=n).astype(np.int32)
        c2 = rng.integers(0, 5, size=n).astype(np.uint64) << np.uint64(40)
        ch.check("lexsort 3 columns, one 64-bit (x64)", lambda: (
            _same_bits(sortx.lexsort([jnp.asarray(c0), jnp.asarray(c1),
                                      jnp.asarray(c2)]),
                       np.lexsort((c0, c1, c2)).astype(np.int32)), ""))

    ch.check("sort descending u32", lambda: (_same_bits(
        sortx.sort(ju, descending=True), np.sort(u)[::-1]), ""))
    ch.check("sort sort_bits=4", lambda: (_same_bits(
        sortx.sort(ju, 4), reference.radix_sort(u, 4)), ""))
    ch.check("argsort u32 stable", lambda: (_same_bits(
        sortx.argsort(jdup), stable.astype(np.int32)), ""))

    rows = rng.integers(0, 2**32, size=rows_shape, dtype=np.uint32)
    rows_dup = (rows & np.uint32(255))
    ch.check(f"sort_rows {rows_shape}", lambda: (_same_bits(
        sortx.sort_rows(jnp.asarray(rows)), np.sort(rows, axis=1)), ""))

    def kv_rows():
        vals = np.broadcast_to(np.arange(rows_shape[1], dtype=np.uint32),
                               rows_shape)
        ks, vs = sortx.sort_kv_rows(jnp.asarray(rows_dup), jnp.asarray(vals))
        order = np.argsort(rows_dup, axis=1, kind="stable")
        return (_same_bits(ks, np.take_along_axis(rows_dup, order, 1))
                and _same_bits(vs, order.astype(np.uint32))), ""

    ch.check(f"sort_kv_rows {rows_shape}", kv_rows)

    a, b = np.sort(dup[: n // 2]), np.sort(dup[n // 2:])
    ch.check("merge", lambda: (_same_bits(
        sortx.merge(jnp.asarray(a), jnp.asarray(b)),
        np.sort(np.concatenate([a, b]))), ""))

    def merge_kv():
        va = np.arange(a.shape[0], dtype=np.uint32)
        vb = np.arange(b.shape[0], dtype=np.uint32) | np.uint32(1 << 31)
        ks, vs = sortx.merge_kv(jnp.asarray(a), jnp.asarray(va),
                                jnp.asarray(b), jnp.asarray(vb))
        k, v = np.concatenate([a, b]), np.concatenate([va, vb])
        order = np.argsort(k, kind="stable")
        return _same_bits(ks, k[order]) and _same_bits(vs, v[order]), ""

    ch.check("merge_kv (a before b on ties)", merge_kv)

    offsets = np.unique(np.concatenate(
        [[0, n], rng.integers(0, n, size=999)])).astype(np.int32)
    seg = np.searchsorted(offsets, np.arange(n), side="right") - 1
    joff = jnp.asarray(offsets)
    seg_order = np.lexsort((dup, seg))
    ch.check("sort_segments", lambda: (_same_bits(
        sortx.sort_segments(jdup, joff), dup[seg_order]), ""))

    def kv_segments():
        ks, vs = sortx.sort_kv_segments(jdup, jnp.arange(n, dtype=jnp.int32),
                                        joff)
        return (_same_bits(ks, dup[seg_order])
                and _same_bits(vs, seg_order.astype(np.int32))), ""

    ch.check("sort_kv_segments", kv_segments)

    def seg_exclusive(x_u32, starts):
        g = np.concatenate([np.zeros(1, np.uint64),
                            np.cumsum(x_u32, dtype=np.uint64)])
        return ((g[:-1] - g[starts]) & 0xFFFFFFFF).astype(np.uint32)

    ch.check("scan_segments", lambda: (_same_bits(
        sortx.scan_segments(ju, joff), seg_exclusive(u, offsets[seg])), ""))

    runs = np.repeat(rng.integers(0, 5, size=n // 8 + 1).astype(np.uint32),
                     8)[:n]
    run_start = np.flatnonzero(np.concatenate([[True], runs[1:] != runs[:-1]]))
    run_of = np.searchsorted(run_start, np.arange(n), side="right") - 1
    ch.check("scan_by_key", lambda: (_same_bits(
        sortx.scan_by_key(jnp.asarray(runs), ju),
        seg_exclusive(u, run_start[run_of])), ""))
    n_runs = run_start.shape[0]
    run_sums = (np.add.reduceat(u.astype(np.uint64), run_start)
                & 0xFFFFFFFF).astype(np.uint32)

    def reduce_by_key():
        rk, rs, nr = sortx.reduce_by_key(jnp.asarray(runs), ju, n_runs)
        return (int(nr) == n_runs and _same_bits(rk, runs[run_start])
                and _same_bits(rs, run_sums)), ""

    ch.check("reduce_by_key", reduce_by_key)

    def sum_by_key():
        dk, ds, nd = sortx.sum_by_key(jdup, ju, 64)
        keys_u, inv = np.unique(dup, return_inverse=True)
        sums = np.zeros(keys_u.shape[0], np.uint64)
        np.add.at(sums, inv, u.astype(np.uint64))
        return (int(nd) == keys_u.shape[0]
                and _same_bits(np.asarray(dk)[:int(nd)], keys_u)
                and _same_bits(np.asarray(ds)[:int(nd)],
                               (sums & 0xFFFFFFFF).astype(np.uint32))), ""

    ch.check("sum_by_key", sum_by_key)

    def rle():
        rv, rl, nr = sortx.run_length_encode(jnp.asarray(runs), n_runs)
        lengths = np.diff(np.concatenate([run_start, [n]])).astype(np.int32)
        return (int(nr) == n_runs and _same_bits(rv, runs[run_start])
                and _same_bits(rl, lengths)), ""

    ch.check("run_length_encode", rle)

    def unique():
        vals, counts, nu = sortx.unique(jdup, 64)
        ev, ec = np.unique(dup, return_counts=True)
        return (int(nu) == ev.shape[0]
                and _same_bits(np.asarray(vals)[:ev.shape[0]], ev)
                and _same_bits(np.asarray(counts)[:ev.shape[0]],
                               ec.astype(np.int32))), ""

    ch.check("unique", unique)
    srt_u = np.sort(u)
    ch.check("kth_value", lambda: (
        int(sortx.kth_value(ju, n // 3)) == int(srt_u[n // 3]), ""))
    ch.check("median", lambda: (
        int(sortx.median(ju)) == int(srt_u[(n - 1) // 2]), ""))

    def top_k():
        vals, idx = sortx.top_k(jdup, 100, return_indices=True)
        order = np.argsort(-dup.astype(np.int64), kind="stable")[:100]
        return (_same_bits(vals, dup[order])
                and _same_bits(idx, order.astype(np.int32))), ""

    ch.check("top_k with indices", top_k)

    def partition():
        mask = (u & 1) == 1
        out, nt = sortx.partition(ju, jnp.asarray(mask))
        return (int(nt) == int(mask.sum())
                and _same_bits(out, np.concatenate([u[mask], u[~mask]]))), ""

    ch.check("partition", partition)
    q = rng.integers(0, 2**32, size=4096, dtype=np.uint32)
    ch.check("searchsorted", lambda: (_same_bits(
        sortx.searchsorted(jnp.asarray(srt_u), jnp.asarray(q)),
        np.searchsorted(srt_u, q).astype(np.int32)), ""))
    ch.check("is_sorted", lambda: (
        bool(sortx.is_sorted(jnp.asarray(srt_u)))
        and not bool(sortx.is_sorted(ju)), ""))
    ch.check("histogram 8 bits at shift 8", lambda: (_same_bits(
        sortx.histogram(ju, 8, 8),
        np.bincount((u >> 8) & 255, minlength=256).astype(np.int32)), ""))

    chunk = n

    def sort_large():
        big = rng.integers(0, 2**32, size=4 * chunk, dtype=np.uint32)
        got = sortx.sort_large(big, chunk_elems=chunk)
        return _same_bits(got, np.sort(big)), f"4 chunks of {chunk}"

    ch.check("sort_large (host merge of device-sorted chunks)", sort_large)


# ---------------------------------------------------------------------
# The distributed phase (--chips 4).

def phase_dist(ch: Checks, n_per_card: int = 1 << 27, cards: int = 4,
               seed: int = 3) -> None:
    import jax
    import jax.numpy as jnp

    import sortx
    from sortx.parallel import make_sort_mesh, shard_1d

    ds = importlib.import_module("sortx.parallel.dist_sort")
    mesh = make_sort_mesh(cards)
    n = cards * n_per_card
    print(f"== distributed phase: {cards} cards, n={n} "
          f"({n_per_card} keys per card); dense exchange (use_ragged=True "
          f"is refused, see sortx/parallel/dist_sort.py)",
          flush=True)
    uniform = jax.random.bits(jax.random.PRNGKey(seed), (n,), jnp.uint32)
    cases = (("uniform", uniform),
             ("all-equal", jnp.full((n,), 0xABCD1234, jnp.uint32)))
    for case, keys in cases:
        kn = np.asarray(keys)
        ks1, vs1 = jax.block_until_ready(
            jax.jit(sortx.sort_kv)(keys, jnp.arange(n, dtype=jnp.uint32)))
        ks1, vs1 = np.asarray(ks1), np.asarray(vs1)
        ch.check(f"one-card sort_kv {case} n={n} (numpy certificate)",
                 lambda: (_stable_certificate(kn, ks1, vs1), ""))
        sk = shard_1d(keys, mesh)
        sv = shard_1d(jnp.arange(n, dtype=jnp.uint32), mesh)

        def dist_sort():
            out, tc, tw = _timed(lambda k: sortx.dist_sort(k, mesh=mesh), sk)
            return (_same_bits(out, ks1) and ds.last_exchange == "dense",
                    ch.timing(tc, tw, _peak()))

        def dist_sort_kv():
            (k2, v2), tc, tw = _timed(
                lambda k, v: sortx.dist_sort_kv(k, v, mesh=mesh), sk, sv)
            return (_same_bits(k2, ks1) and _same_bits(v2, vs1),
                    ch.timing(tc, tw, _peak()))

        def dist_sort_padded():
            out, pad = sortx.dist_sort_padded(sk, mesh=mesh)
            out = np.asarray(out)
            return (_same_bits(out[:n], ks1)
                    and np.all(out[n:] == 0xFFFFFFFF)), f"pad {pad}"

        def dist_scan():
            x = sk.view(jnp.int32)
            (s, t), tc, tw = _timed(
                lambda a: sortx.dist_scan(a, with_total=True, mesh=mesh), x)
            one = np.asarray(jax.jit(sortx.scan)(keys.view(jnp.int32)))
            exp = _np_scan(kn, False)
            return (_same_bits(np.asarray(s).view(np.uint32), exp)
                    and _same_bits(one.view(np.uint32), exp)
                    and np.uint32(np.asarray(t).view(np.uint32))
                    == np.uint32((int(exp[-1]) + int(kn[-1])) & 0xFFFFFFFF),
                    ch.timing(tc, tw, _peak()))

        ch.check(f"dist_sort {case} vs one-card sort_kv", dist_sort)
        ch.check(f"dist_sort_kv stable {case} vs one-card sort_kv",
                 dist_sort_kv)
        ch.check(f"dist_sort_padded {case}", dist_sort_padded)
        ch.check(f"dist_scan {case} vs numpy and one-card scan", dist_scan)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4 runs only the distributed phase, on 4 cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    card = card_info()
    print(f"card: {card}", flush=True)
    devs = preflight()

    import sortx  # noqa: F401  (fails here in a tree without sortx)
    from sortx.runtime import native
    from sortx.runtime.cache import enable_cache

    print(f"compile cache: {enable_cache()}", flush=True)
    ch = Checks(card.splitlines()[0] if card else "unknown card")
    ch.check("native library built from csrc/",
             lambda: (native.build_native(force=True), ""))
    if args.chips == 4:
        if len(devs) < 4:
            ch.check("four cards visible", lambda: (False, f"{len(devs)}"))
        else:
            phase_dist(ch, seed=args.seed + 3)
    else:
        phase_main(ch, seed=args.seed)
        phase_scan_kernel(ch, seed=args.seed + 1)
        phase_surface(ch, seed=args.seed + 2)
    print(f"card: {card}", flush=True)
    if ch.failed:
        print(f"{len(ch.failed)} check(s) FAILED: {ch.failed}", flush=True)
        return 1
    print(f"all {ch.passed} checks passed", flush=True)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
