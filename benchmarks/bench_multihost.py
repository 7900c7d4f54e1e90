"""Multi-process multihost sort at scale -> MULTIHOST_SCALE.json.

Multihost beyond toy scale (the pytest tier runs 2 processes x 40k
keys). This benchmark runs BASELINE.json config 5's
shape — N >= 2 processes, one device group each, a single global sort —
at real sizes (default total 2^27; --n 30 reproduces the 2^30 target on
a big-RAM host), measuring wall time and emitting a machine-readable
artifact.

Usage:
  python benchmarks/bench_multihost.py [--n LOG2_TOTAL] [--procs P]
  python benchmarks/bench_multihost.py --worker <pid> <port> ...  (internal)

Each worker GENERATES its own shard rows deterministically (the global
array is never materialized in one place), runs dist_sort_padded
(evenly-sharded output, the scale-safe API), and verifies:
  - each addressable output shard is internally sorted;
  - shard boundaries are non-decreasing across processes (allgather of
    per-shard [min, max] scalars);
  - the global multiset is preserved (allgather of per-shard u64 sum,
    xor-fold, and count — compared against the input's).
Bit-exact oracle equality at these sizes is the job of the pytest tier
(tests/test_multihost.py + the opt-in scale test); this artifact proves
the multi-process path at volume and records throughput.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --------------------------- worker ---------------------------------

def worker(pid: int, port: int, nprocs: int, log_n: int,
           dev_per_proc: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", dev_per_proc)

    from sortx.runtime.cache import enable_cache

    enable_cache()

    from sortx.parallel import init_multihost

    init_multihost(coordinator_address=f"localhost:{port}",
                   num_processes=nprocs, process_id=pid)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sortx.parallel import AXIS, dist_sort_padded, make_sort_mesh

    assert jax.process_count() == nprocs
    mesh = make_sort_mesh()
    d = len(jax.devices())
    n = 1 << log_n
    m = n // d
    assert n % d == 0
    sh = NamedSharding(mesh, P(AXIS))

    # Generate MY rows only; deterministic per shard id.
    rows = range(pid * dev_per_proc, (pid + 1) * dev_per_proc)
    locs = []
    in_sum = np.uint64(0)
    in_xor = np.uint64(0)
    for r in rows:
        rng = np.random.RandomState(1234 + r)
        blk = rng.randint(0, 2**32, size=m, dtype=np.uint32)
        in_sum += np.uint64(blk.astype(np.uint64).sum())
        in_xor ^= np.uint64(np.bitwise_xor.reduce(blk.astype(np.uint64)))
        locs.append(blk)
    local = np.concatenate(locs)
    del locs
    arr = jax.make_array_from_process_local_data(sh, local, (n,))
    del local

    def sync(x):
        # CLAUDE.md rule: dependent scalar fetch, never
        # block_until_ready alone (a full reduction works on sharded
        # multi-process arrays).
        return float(jnp.max(x))

    t0 = time.perf_counter()
    out, pad = dist_sort_padded(arr, mesh=mesh)
    sync(out)
    t_cold = time.perf_counter() - t0
    assert pad == 0

    # warm timing: re-sort the (sorted) output xor a multiplicative
    # scramble so the work is genuine
    salt = jnp.uint32(0x9E3779B9)
    mul = jnp.uint32(2654435761)

    t0 = time.perf_counter()
    out2, _ = dist_sort_padded((out * mul) ^ salt, mesh=mesh)
    sync(out2)
    t_warm = time.perf_counter() - t0

    # ---- verification on the cold output ----------------------------
    mins, maxs, sums, xors, counts = [], [], [], [], []
    for s in sorted(out.addressable_shards,
                    key=lambda s: s.index[0].start):
        a = np.asarray(s.data)
        assert np.all(a[1:] >= a[:-1]), f"[{pid}] shard not sorted"
        mins.append(int(a[0]))
        maxs.append(int(a[-1]))
        sums.append(int(a.astype(np.uint64).sum()))  # wraps mod 2^64
        xors.append(int(np.bitwise_xor.reduce(a.astype(np.uint64))))
        counts.append(len(a))
        del a

    # tiny cross-process metadata exchange: reshard a [d, k] table to
    # replicated through the mesh itself
    from jax.sharding import PartitionSpec

    mm = np.stack([np.array(mins, np.int64), np.array(maxs, np.int64)],
                  axis=1)  # my shards' [min, max]
    mm_arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, PartitionSpec(AXIS)), mm, (d, 2))
    gathered = np.asarray(jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh, PartitionSpec()))(
            mm_arr))
    for i in range(d - 1):
        assert gathered[i, 1] <= gathered[i + 1, 0], \
            f"[{pid}] boundary {i} decreasing: {gathered[i]} -> " \
            f"{gathered[i+1]}"

    m63 = (1 << 63) - 1              # fit the int64 transport lanes
    sx = np.array([[sum(sums) & m63,
                    int(np.bitwise_xor.reduce(
                        np.array(xors, np.uint64))) & m63,
                    sum(counts),
                    int(in_sum) & m63,
                    int(in_xor) & m63]], np.int64)
    sx_arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, PartitionSpec(AXIS)),
        np.repeat(sx, dev_per_proc, 0), (d, 5))
    g = np.asarray(jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh, PartitionSpec()))(
            sx_arr))
    # global sums: sum over one row per process
    rows_per_proc = g.reshape(nprocs, dev_per_proc, 5)[:, 0, :]
    m63 = (1 << 63) - 1
    out_sum = int(rows_per_proc[:, 0].astype(np.uint64).sum()) & m63
    out_xor = int(np.bitwise_xor.reduce(
        rows_per_proc[:, 1].astype(np.uint64))) & m63
    total = int(rows_per_proc[:, 2].sum())
    in_sum_g = int(rows_per_proc[:, 3].astype(np.uint64).sum()) & m63
    in_xor_g = int(np.bitwise_xor.reduce(
        rows_per_proc[:, 4].astype(np.uint64))) & m63
    assert total == n, f"[{pid}] count {total} != {n}"
    assert out_sum == in_sum_g, f"[{pid}] sum mismatch"
    assert out_xor == in_xor_g, f"[{pid}] xor mismatch"

    if pid == 0:
        print(json.dumps({
            "metric": "multihost_sort",
            "processes": nprocs,
            "devices": d,
            "keys": n,
            "wall_s_cold": round(t_cold, 2),
            "wall_s_warm": round(t_warm, 2),
            "keys_per_s_warm": round(n / t_warm, 1),
            "backend": jax.default_backend(),
            "verified": ["shards_sorted", "boundaries", "multiset_sum_xor",
                         "count"],
        }), flush=True)
    print(f"[{pid}] MULTIHOST_SCALE_OK", flush=True)


# --------------------------- driver ---------------------------------

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=27, help="log2 total keys")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--dev-per-proc", type=int, default=2)
    ap.add_argument("--worker", nargs=4, type=int, default=None,
                    metavar=("PID", "PORT", "PROCS", "LOGN"))
    ap.add_argument("--dpp", type=int, default=None)
    args = ap.parse_args()

    if args.worker is not None:
        pid, port, procs, logn = args.worker
        worker(pid, port, procs, logn, args.dpp or 2)
        return

    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(pid), str(port), str(args.procs),
             str(args.n), "--dpp", str(args.dev_per_proc)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=_ROOT)
        for pid in range(args.procs)
    ]
    outs = []
    deadline = 3600
    for p in procs:
        try:
            out, _ = p.communicate(timeout=deadline)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise SystemExit("multihost workers timed out")
        outs.append(out)
    record = None
    ok = 0
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            sys.stderr.write(out[-4000:])
            raise SystemExit(f"worker {pid} failed rc={p.returncode}")
        if f"[{pid}] MULTIHOST_SCALE_OK" in out:
            ok += 1
        for line in out.splitlines():
            if line.startswith("{") and "multihost_sort" in line:
                record = json.loads(line)
    assert ok == args.procs, "not all workers verified"
    assert record is not None
    out_path = os.path.join(os.path.dirname(__file__),
                            "MULTIHOST_SCALE.json")
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
