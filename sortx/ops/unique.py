"""unique — sorted distinct values with counts, fixed-size output.

Beyond-reference convenience (the reference has no set operations), with
``jnp.unique``-style static ``size`` semantics so it is jittable.

In place of the classic "flag firsts -> scan -> scatter-compact"
shape, the compaction IS a sort: a stable 1-bit key-value sort on the
duplicate flag (0 = first occurrence, 1 = duplicate) moves every first
occurrence to the front in order, carrying the element POSITIONS as
values. The first ``size`` positions then drive O(size) gathers for
values and counts (size is the user's bound, typically << n).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import Config, default_config
from ..runtime.launcher import profiled
from .sort import _check_keys, _to_radix_u32, sort as _sort
from .sort import sort_kv as _sort_kv

__all__ = ["unique"]


@profiled("unique")
def unique(x, size: int, *, assume_sorted: bool = False,
           fill_value=None, config: Config | None = None):
    """Sorted distinct values of ``x`` with their multiplicities.

    Args:
      x: 1D u32/i32/f32 (or 16-bit) array.
      size: static output length (jit-compatible, like ``jnp.unique``).
        Slots past the number of distinct values are filled.
      assume_sorted: skip the initial sort if ``x`` is already
        ascending.
      fill_value: value for unused slots (default: the last distinct
        value, matching ``jnp.unique``); count fill is always 0.

    Returns:
      ``(values[size], counts[size], num_unique)`` — ``num_unique`` is
      the total number of distinct values (may exceed ``size``; the
      first ``min(num_unique, size)`` slots are valid). NaN floats
      compare unequal to themselves, so each NaN counts as distinct
      (numpy semantics).
    """
    cfg = config or default_config()
    _check_keys(x)
    n = x.shape[0]
    if size < 1:
        raise ValueError("size must be >= 1")
    if n == 0:
        fv = jnp.zeros((), x.dtype) if fill_value is None else \
            jnp.asarray(fill_value, x.dtype)
        return (jnp.full((size,), fv, x.dtype),
                jnp.zeros((size,), jnp.int32),
                jnp.zeros((), jnp.int32))

    xs = x if assume_sorted else _sort(x, config=cfg)
    # Duplicate flag on the RADIX image: bitwise inequality, so float
    # -0.0 vs +0.0 stay distinct values and NaNs are per-bit-pattern
    # (total-order semantics, consistent with the sort itself).
    k, _ = _to_radix_u32(xs)
    dup = jnp.concatenate([jnp.zeros((1,), jnp.uint32),
                           (k[1:] == k[:-1]).astype(jnp.uint32)])
    num_unique = (n - jnp.sum(dup)).astype(jnp.int32)

    # Stable 1-bit KV sort: first-occurrence positions move to the
    # front, in ascending value order (stability preserves it).
    pos = jnp.arange(n, dtype=jnp.uint32)
    _, first_pos = _sort_kv(dup, pos, sort_bits=1, config=cfg)

    fp = jnp.pad(first_pos.astype(jnp.int32), (0, size + 1))
    slot = jnp.arange(size, dtype=jnp.int32)
    valid = slot < num_unique
    safe_idx = jnp.where(valid, fp[:size], 0)
    vals = xs[safe_idx]

    # counts[i] = next first-position - this one; the last valid slot
    # closes at n.
    nxt = jnp.where(slot + 1 < num_unique, fp[1:size + 1], n)
    counts = jnp.where(valid, nxt - safe_idx, 0).astype(jnp.int32)

    if fill_value is None:
        fv = vals[jnp.maximum(jnp.minimum(num_unique, size) - 1, 0)]
    else:
        fv = jnp.asarray(fill_value, x.dtype)
    vals = jnp.where(valid, vals, fv)
    return vals, counts, num_unique
