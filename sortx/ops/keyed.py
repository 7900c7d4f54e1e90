"""Stream compaction and key-grouped reductions.

Beyond-reference breadth (the reference exposes only scan/sort/sort_kv,
``Pprims.h:35-41``) — these are the CUB-family companions
(``DevicePartition`` / ``DeviceSelect`` / ``DeviceReduce::ReduceByKey``
/ ``DeviceRunLengthEncode``) every sort/scan library grows, built on
the same sort and scan so they inherit their correctness guarantees.

Two scatter-free shapes replace the classic "flag -> scan -> scatter"
compaction:

  * moving-compaction (``partition``): the compaction IS a stable
    1-bit key-value sort on the flag, carrying the DATA as the value
    lane;
  * index-compaction (``reduce_by_key`` / ``run_length_encode``): the
    same 1-bit sort carries POSITIONS; the first ``size`` positions
    drive O(size) gathers, and the per-run sums come from the flat
    ``sortx.scan`` sampled at the run boundaries (sum of run i
    = g[start[i+1]] - g[start[i]]) — no segmented reduction pass.

Outputs are fixed-size (static ``size`` bound, ``jnp.unique``-style)
so everything is jittable.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import Config, default_config
from ..runtime.launcher import profiled
from .scan import scan
from .sort import _check_keys, _to_radix_u32, sort_kv as _sort_kv

__all__ = ["partition", "reduce_by_key", "sum_by_key",
           "run_length_encode", "searchsorted", "is_sorted"]


@profiled("partition")
def partition(x, mask, *, config: Config | None = None):
    """Stable partition: selected elements first, both groups in order.

    Args:
      x: 1D array of any 32-bit dtype (or 16-bit — anything ``sort_kv``
        accepts as a value lane).
      mask: bool array like ``x`` — True = goes to the front.

    Returns:
      ``(out, num_true)``: ``out[:num_true]`` are the masked-in
      elements in their original relative order, ``out[num_true:]`` the
      masked-out ones in theirs (CUB ``DevicePartition::Flagged``; the
      first half alone is ``DeviceSelect::Flagged``).
    """
    cfg = config or default_config()
    if x.ndim != 1:
        raise ValueError("partition expects a 1D array")
    if mask.shape != x.shape:
        raise ValueError("mask must have the same shape as x")
    if mask.dtype != jnp.bool_:
        raise TypeError("mask must be boolean")
    n = x.shape[0]
    num_true = jnp.sum(mask).astype(jnp.int32)
    if n == 0:
        return x, num_true
    # Key 0 = selected, 1 = rejected: the stable 1-bit KV sort moves
    # every selected element to the front, original order preserved.
    flag = jnp.where(mask, jnp.uint32(0), jnp.uint32(1))
    _, out = _sort_kv(flag, x, sort_bits=1, config=cfg)
    return out, num_true


def _run_starts(k_img, cfg: Config):
    """Start positions of consecutive equal-key runs, compacted.

    ``k_img``: u32 radix image (bitwise equality — float -0.0 vs +0.0
    stay distinct, NaNs compare per bit pattern, consistent with the
    sort's total order). Returns ``(starts_i32[n], num_runs)`` where the
    first ``num_runs`` entries are the run starts in ascending order
    (the stable 1-bit sort keeps position order within the flag=0
    class).
    """
    n = k_img.shape[0]
    dup = jnp.concatenate([jnp.zeros((1,), jnp.uint32),
                           (k_img[1:] == k_img[:-1]).astype(jnp.uint32)])
    num_runs = (n - jnp.sum(dup)).astype(jnp.int32)
    pos = jnp.arange(n, dtype=jnp.uint32)
    _, starts = _sort_kv(dup, pos, sort_bits=1, config=cfg)
    return starts.astype(jnp.int32), num_runs


def _consecutive_reduce(keys, values, size: int, fill_value, cfg: Config):
    """Shared body of reduce_by_key / run_length_encode.

    ``values=None`` means "count run lengths" (RLE); otherwise sum the
    values of each run mod 2^32. Returns (keys_out, agg, num_runs).
    """
    n = keys.shape[0]
    if size < 1:
        raise ValueError("size must be >= 1")
    if n == 0:
        fv = jnp.zeros((), keys.dtype) if fill_value is None else \
            jnp.asarray(fill_value, keys.dtype)
        agg_dt = jnp.int32 if values is None else values.dtype
        return (jnp.full((size,), fv, keys.dtype),
                jnp.zeros((size,), agg_dt),
                jnp.zeros((), jnp.int32))

    k_img, _ = _to_radix_u32(keys)
    starts, num_runs = _run_starts(k_img, cfg)

    fp = jnp.pad(starts, (0, size + 1))
    slot = jnp.arange(size, dtype=jnp.int32)
    valid = slot < num_runs
    safe_start = jnp.where(valid, fp[:size], 0)
    keys_out = keys[safe_start]
    # Run i ends where run i+1 starts; the last valid run closes at n.
    nxt = jnp.where(slot + 1 < num_runs, fp[1:size + 1], n)

    if values is None:
        agg = jnp.where(valid, nxt - safe_start, 0).astype(jnp.int32)
    else:
        vu = values.view(jnp.uint32) if values.dtype == jnp.int32 else values
        g, gt = scan(vu, with_total=True, config=cfg)
        g_ext = jnp.concatenate([g, gt[None]])
        sums = g_ext[nxt] - g_ext[safe_start]
        sums = jnp.where(valid, sums, jnp.uint32(0))
        agg = sums.view(jnp.int32) if values.dtype == jnp.int32 else sums

    if fill_value is None:
        fv = keys_out[jnp.maximum(jnp.minimum(num_runs, size) - 1, 0)]
    else:
        fv = jnp.asarray(fill_value, keys.dtype)
    keys_out = jnp.where(valid, keys_out, fv)
    return keys_out, agg, num_runs


@profiled("reduce_by_key")
def reduce_by_key(keys, values, size: int, *, fill_value=None,
                  config: Config | None = None):
    """Sum ``values`` over runs of CONSECUTIVE equal keys.

    CUB ``DeviceReduce::ReduceByKey`` (sum) semantics: a new output
    segment starts wherever ``keys[i] != keys[i-1]`` — the input is NOT
    sorted first (use :func:`sum_by_key` to group globally). Equality is
    bitwise on the radix image (floats: -0.0 and +0.0 are distinct,
    NaNs per bit pattern — consistent with ``sortx.sort``'s total
    order).

    Args:
      keys: 1D u32/i32/f32 (or 16-bit) array.
      values: int32/uint32 array like ``keys``; sums wrap mod 2^32
        (same contract as ``sortx.scan``).
      size: static output length; slots past ``num_runs`` are filled
        (``fill_value`` for keys — default: the last run's key; 0 for
        sums).

    Returns:
      ``(run_keys[size], run_sums[size], num_runs)`` — ``num_runs`` may
      exceed ``size``; the first ``min(num_runs, size)`` slots are valid.
    """
    cfg = config or default_config()
    _check_keys(keys)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    if values.dtype not in (jnp.int32, jnp.uint32):
        raise TypeError("reduce_by_key sums 32-bit integer values, got "
                        f"{values.dtype}")
    return _consecutive_reduce(keys, values, size, fill_value, cfg)


@profiled("sum_by_key")
def sum_by_key(keys, values, size: int, *, fill_value=None,
               config: Config | None = None):
    """Sum ``values`` grouped by key GLOBALLY (keys need not be sorted).

    ``sort_kv`` + :func:`reduce_by_key`: output keys are the distinct
    keys in ascending order with the total of every occurrence. The
    grouping sort runs ``stable=False`` — mod-2^32 addition is
    commutative, so value order within a key group cannot change the
    sums.

    Returns ``(distinct_keys[size], sums[size], num_distinct)``.
    """
    cfg = config or default_config()
    _check_keys(keys)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    if values.dtype not in (jnp.int32, jnp.uint32):
        raise TypeError("sum_by_key sums 32-bit integer values, got "
                        f"{values.dtype}")
    if keys.shape[0] == 0:
        return _consecutive_reduce(keys, values, size, fill_value, cfg)
    ks, vs = _sort_kv(keys, values, stable=False, config=cfg)
    return _consecutive_reduce(ks, vs, size, fill_value, cfg)


@profiled("run_length_encode")
def run_length_encode(x, size: int, *, fill_value=None,
                      config: Config | None = None):
    """Lengths of consecutive equal-value runs (CUB RunLengthEncode).

    Returns ``(run_values[size], run_lengths[size], num_runs)``; length
    fill is 0, value fill as in :func:`reduce_by_key`.
    """
    cfg = config or default_config()
    _check_keys(x)
    return _consecutive_reduce(x, None, size, fill_value, cfg)


def searchsorted(sorted_keys, queries, *, side: str = "left",
                 config: Config | None = None):
    """Insertion points of ``queries`` into ``sorted_keys``.

    Like ``jnp.searchsorted``, but using the SAME total order as
    ``sortx.sort`` (monotone radix transforms): float keys order with
    -NaN < -inf < ... < +inf < +NaN, so an array produced by
    ``sortx.sort`` is always a valid haystack even with NaNs (plain
    ``jnp.searchsorted`` gives unspecified results there). Both arrays
    must share a dtype.
    """
    if side not in ("left", "right"):
        raise ValueError("side must be 'left' or 'right'")
    _check_keys(sorted_keys)
    if queries.ndim != 1:
        raise ValueError("searchsorted expects 1D queries")
    if queries.dtype != sorted_keys.dtype:
        raise TypeError("sorted_keys and queries must share a dtype")
    a, _ = _to_radix_u32(sorted_keys)
    q, _ = _to_radix_u32(queries)
    return jnp.searchsorted(a, q, side=side).astype(jnp.int32)


def is_sorted(x, *, descending: bool = False):
    """Scalar bool: is ``x`` sorted in ``sortx.sort``'s total order?

    The check the engines' presorted fast path performs, exposed
    (floats use the monotone-transform order, so NaNs have a defined
    place instead of poisoning the comparison).
    """
    _check_keys(x)
    if x.shape[0] <= 1:
        return jnp.bool_(True)
    k, _ = _to_radix_u32(x)
    if descending:
        return jnp.all(k[1:] <= k[:-1])
    return jnp.all(k[1:] >= k[:-1])
