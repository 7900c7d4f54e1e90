"""Worker for the real 2-process multihost test (tests/test_multihost.py).

Each process owns 2 CPU devices; jax.distributed connects them via gloo
into one 4-device mesh spanning both processes — the same code path a
multi-host cluster uses (one process per host). Run:
    python tests/mh_worker.py <process_id> <port>
"""
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

pid = int(sys.argv[1])
port = sys.argv[2]

from sortx.parallel import init_multihost  # noqa: E402

init_multihost(coordinator_address=f"localhost:{port}",
               num_processes=2, process_id=pid)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from sortx.parallel import (AXIS, dist_sort, dist_sort_kv,  # noqa: E402
                            dist_sort_padded, is_multihost, make_sort_mesh)

assert is_multihost() and jax.process_count() == 2
mesh = make_sort_mesh()
d = len(jax.devices())
assert d == 4

rng = np.random.RandomState(7)
n = 40_000
keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)  # same in both procs
m = n // d
sh = NamedSharding(mesh, P(AXIS))
my_rows = slice(pid * 2, (pid + 1) * 2)  # 2 shards per process
local = keys.reshape(d, m)[my_rows].reshape(-1)
arr = jax.make_array_from_process_local_data(sh, local, (n,))

out = dist_sort(arr, mesh=mesh)
exp = np.sort(keys)
for s in out.addressable_shards:
    lo, hi = s.index[0].start, s.index[0].stop
    assert np.array_equal(np.asarray(s.data), exp[lo:hi]), \
        f"[{pid}] shard {lo}:{hi} mismatch"

# kv stability across hosts (duplicate-heavy)
kd = (keys % 97).astype(np.uint32)
vals = np.arange(n, dtype=np.uint32)
ka = jax.make_array_from_process_local_data(
    sh, kd.reshape(d, m)[my_rows].reshape(-1), (n,))
va = jax.make_array_from_process_local_data(
    sh, vals.reshape(d, m)[my_rows].reshape(-1), (n,))
ks, vs = dist_sort_kv(ka, va, mesh=mesh)
order = np.argsort(kd, kind="stable")
for s in vs.addressable_shards:
    lo, hi = s.index[0].start, s.index[0].stop
    assert np.array_equal(np.asarray(s.data), vals[order][lo:hi]), \
        f"[{pid}] kv shard mismatch"

# ragged n through the scale-safe padded API (replicated output is the
# multi-process unpadded fallback; padded stays evenly sharded)
n2 = n - 13
k2 = keys[:n2]
m2 = -(-n2 // d)
pad_in = np.pad(k2, (0, d * m2 - n2))  # even per-process rows to build
loc2 = pad_in.reshape(d, m2)[my_rows].reshape(-1)
# build the ragged global array: only possible padded; exercise the
# padded API on a divisible global instead, with ragged semantics left
# to single-process tests.
arr2 = jax.make_array_from_process_local_data(sh, loc2, (d * m2,))
p_out, pad = dist_sort_padded(arr2, mesh=mesh)
assert pad == 0
exp2 = np.sort(pad_in)
for s in p_out.addressable_shards:
    lo, hi = s.index[0].start, s.index[0].stop
    assert np.array_equal(np.asarray(s.data), exp2[lo:hi])

print(f"[{pid}] MULTIHOST_OK", flush=True)
