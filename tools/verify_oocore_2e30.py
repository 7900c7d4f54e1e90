"""Full-scale out-of-core proof: 2^30 keys (4 GiB) through sort_large.

Runs on the CPU backend: the chunked staging + native parallel k-way
merge is the same code on every backend (chip_smoke.py drives
sort_large on the GPU at 2^22-key chunks).

Usage: python tools/verify_oocore_2e30.py [log2_n]
"""

import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import sortx

log_n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
n = 1 << log_n
print(f"generating 2^{log_n} = {n} keys ({4 * n / 2**30:.1f} GiB)",
      flush=True)
rng = np.random.default_rng(7)
big = rng.integers(0, 2**32, n, dtype=np.uint32)

t0 = time.perf_counter()
out = sortx.sort_large(big, chunk_elems=1 << 26)
dt = time.perf_counter() - t0
print(f"sort_large: {dt:.1f}s = {n / dt / 1e6:.0f} MKeys/s "
      f"({(1 << log_n) >> 26} chunks of 2^26)", flush=True)

t0 = time.perf_counter()
exp = np.sort(big)
print(f"np.sort oracle: {time.perf_counter() - t0:.1f}s", flush=True)
assert out.shape[0] == n and np.array_equal(out, exp), "MISMATCH"
print(f"PASS sort_large 2^{log_n} out-of-core bit-exact", flush=True)
