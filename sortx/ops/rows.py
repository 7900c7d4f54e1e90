"""Batched independent row sorts: ``sort_rows`` / ``sort_kv_rows``.

Beyond-reference capability (the reference is strictly 1D,
``Pprims.h:35-41``), but the natural batched form of the same
contract: one ``lax.sort`` along the last axis of a [B, L] array.

Stability: ``sort_kv_rows`` sorts stably on the key, so equal keys keep
their original in-row order.
"""

from __future__ import annotations

import jax

from ..config import Config
from ..runtime.launcher import profiled
from .sort import _to_radix_u32

__all__ = ["sort_rows", "sort_kv_rows"]


def _check(keys):
    from .sort import _check_key_dtype

    if keys.ndim != 2:
        raise ValueError("sort_rows expects a 2D [batch, length] array")
    _check_key_dtype(keys.dtype, "sort_rows")


@profiled("sort_rows")
def sort_rows(keys, *, descending: bool = False,
              config: Config | None = None):
    """Sort every row of a [B, L] array independently.

    Keys follow the same dtype contract as ``sortx.sort`` (u32/i32/f32,
    monotone bit transforms). Row length and batch are unconstrained."""
    del config
    _check(keys)
    B, L = keys.shape
    if B == 0 or L <= 1:
        return keys
    k, undo = _to_radix_u32(keys)
    if descending:
        k = ~k
    out = jax.lax.sort(k, dimension=1)
    return undo(~out if descending else out)


@profiled("sort_kv_rows")
def sort_kv_rows(keys, values, *, descending: bool = False,
                 config: Config | None = None):
    """Stable per-row key-value sort of [B, L] arrays (values follow
    keys; equal keys keep their original in-row order). Values may be
    any dtype."""
    del config
    _check(keys)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    B, L = keys.shape
    if B == 0 or L <= 1:
        return keys, values
    k, undo = _to_radix_u32(keys)
    if descending:
        k = ~k
    ks, vs = jax.lax.sort([k, values], dimension=1, num_keys=1,
                          is_stable=True)
    return undo(~ks if descending else ks), vs
