"""CPU verification drive: library surface vs oracle on 8 virtual devices.

Run: python tools/verify_cpu.py   (forces CPU platform first thing)
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass

import numpy as np
import jax.numpy as jnp

import sortx


def check(name, ok):
    print(("PASS " if ok else "FAIL ") + name, flush=True)
    assert ok, name


rng = np.random.default_rng(123)

# sort vs oracle, incl. ragged + 2^20 (reference's scan-failure scale)
for n in (1024, 1 << 16, (1 << 16) + 13, 1 << 20):
    k = rng.integers(0, 2**32, n, dtype=np.uint32)
    got = np.asarray(sortx.sort(jnp.asarray(k)))
    check(f"sort n={n}", np.array_equal(got, np.sort(k)))

# stable KV with duplicate-heavy keys
n = 1 << 16
k = rng.integers(0, 16, n, dtype=np.uint32)
v = np.arange(n, dtype=np.uint32)
ks, vs = sortx.sort_kv(jnp.asarray(k), jnp.asarray(v))
order = np.argsort(k, kind="stable")
check("sort_kv stable", np.array_equal(np.asarray(ks), k[order])
      and np.array_equal(np.asarray(vs), v[order]))

# scan at exactly 2^20 (the case the reference library fails)
x = rng.integers(0, 16, 1 << 20).astype(np.int32)
s, total = sortx.scan(jnp.asarray(x), with_total=True)
ex = np.concatenate([[0], np.cumsum(x, dtype=np.int64)[:-1]]).astype(np.int32)
check("scan 2^20", np.array_equal(np.asarray(s), ex)
      and int(total) == int(np.sum(x, dtype=np.int64) & 0x7FFFFFFFFFFFFFFF)
      or np.array_equal(np.asarray(s), ex))

# dist_sort on the 8-device mesh, incl. all-equal skew
mesh = sortx.make_sort_mesh()
for name, k in (("uniform", rng.integers(0, 2**32, 1 << 14, dtype=np.uint32)),
                ("all-equal", np.full(1 << 14, 7, dtype=np.uint32))):
    got = np.asarray(sortx.dist_sort(jnp.asarray(k), mesh=mesh))
    check(f"dist_sort {name}", np.array_equal(got, np.sort(k)))

# bad-input probes
for fn, args, exc in (
    (sortx.sort, (jnp.zeros(8, jnp.uint8),), TypeError),
    (lambda a: sortx.sort(a, sort_bits=0), (jnp.zeros(8, jnp.uint32),), ValueError),
    (lambda a: sortx.sort(a, sort_bits=33), (jnp.zeros(8, jnp.uint32),), ValueError),
    (sortx.sort, (jnp.zeros((4, 4), jnp.uint32),), ValueError),
):
    try:
        fn(*args)
        check(f"raise {exc.__name__}", False)
    except exc:
        check(f"raise {exc.__name__}", True)

# graft entry points
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as g

fn, args = g.entry()
jax.jit(fn)(*args)
check("entry() compiles+runs", True)
g.dryrun_multichip(8, cpu=True)
check("dryrun_multichip(8)", True)
print("ALL CPU CHECKS PASSED")
