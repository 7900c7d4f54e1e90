"""Headline benchmark: u32 keys/s for a 2^27-key single-GPU sort.

Prints the result JSON line {"metric", "value", "unit", "vs_baseline",
"device", "card", "extras"} INCREMENTALLY: once after the headline
measurement and again (merged, superseding) after each extra, so a
timeout after the headline still leaves a parseable record. An extra
that fails is recorded under ``<name>_error`` and makes the script exit
nonzero once the rest have run.

Baseline = the reference's published ~520 MKeys/s 32-bit radix sort
throughput on an AMD HD5870/HD6970 (BASELINE.md; Harada & Howes paper §4).

Timing: every shape is compiled and run once outside the clock; each
timed call ends in ``block_until_ready``, and the figure is the median
of ``ITERS`` calls. Needs a GPU: on any other platform it exits nonzero
without a result.
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

import sortx
from sortx.runtime.cache import enable_cache

N = 1 << 27
ITERS = 10


def _median_seconds(fn, *args) -> float:
    """Median wall seconds of ``fn(*args)`` to ``block_until_ready``,
    after one untimed call that compiles it."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: needs a GPU, JAX platform is {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    enable_cache()
    keys = jax.random.bits(jax.random.PRNGKey(123), (N,), dtype=jnp.uint32)
    vals = jax.random.bits(jax.random.PRNGKey(7), (N,), dtype=jnp.uint32)
    print("bench: headline (progress on stderr; stdout gets JSON lines)",
          file=sys.stderr, flush=True)
    keys_per_s = N / _median_seconds(jax.jit(sortx.sort), keys)
    extras = {}
    result = {
        "metric": "u32_radix_sort_keys_per_s_single_chip_2e27",
        "value": keys_per_s,
        "unit": "keys/s",
        "vs_baseline": keys_per_s / 520e6,  # BASELINE.md row 1
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "card": _card(),
        "extras": extras,
    }
    print(json.dumps(result), flush=True)

    def extra(name, fn, *args, n=N):
        print(f"bench: {name}", file=sys.stderr, flush=True)
        try:
            extras[name] = n / _median_seconds(jax.jit(fn), *args)
        except Exception as e:
            extras[name + "_error"] = repr(e)[:200]
        print(json.dumps(result), flush=True)

    extra("kv_keys_per_s", sortx.sort_kv, keys, vals)
    extra("kv_unstable_keys_per_s",
          lambda k, v: sortx.sort_kv(k, v, stable=False), keys, vals)
    extra("u64_keys_per_s", sortx.sort_u64, keys, vals)
    extra("partial4_stable_keys_per_s", lambda k: sortx.sort(k, 4), keys)
    with jax.enable_x64(True):
        v64 = (vals.astype(jnp.uint64) << jnp.uint64(32)) | keys.astype(
            jnp.uint64)
        extra("kv_v64_keys_per_s", sortx.sort_kv, keys, v64)
    extra("scan_elems_per_s", sortx.scan,
          (keys & jnp.uint32(0xFFFF)).view(jnp.int32))
    extra("rows_keys_per_s", sortx.sort_rows, keys.reshape(2048, 65536))
    srt = jax.jit(sortx.sort)(keys)
    extra("merge_keys_per_s", sortx.merge, srt[:N // 2], srt[N // 2:])
    extra("presorted_keys_per_s", sortx.sort, jnp.arange(N, dtype=jnp.uint32))
    extra("reverse_keys_per_s", sortx.sort,
          jnp.arange(N, dtype=jnp.uint32)[::-1])
    extra("all_equal_keys_per_s", sortx.sort,
          jnp.full((N,), 0xABCD1234, jnp.uint32))
    failed = [k for k in extras if k.endswith("_error")]
    if failed:
        print(f"bench: failed extras {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
