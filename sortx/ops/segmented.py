"""Ragged segmented sort: independently sort contiguous segments.

Beyond-reference capability (the reference is strictly one flat array,
``Pprims.h:35-41``; its demo sorts many sizes only one at a time —
``UnitTest/main.cpp:88-141``), but the standard companion of a batched
sort library (CUB's ``DeviceSegmentedSort`` shape) and the ragged
complement of ``sort_rows``: segments of ANY mixed lengths, given by an
offsets vector, each sorted independently in ONE engine pass.

No per-segment dispatch, no padding to a rectangle.
Each element's segment id (a cheap ``searchsorted`` against the offsets)
becomes the HIGH word of a 64-bit composite key and the radix-u32 key
the LOW word; one (hi, lo) lexicographic sort (``ops/extras.sort_u64``)
then sorts every segment in place — segments never interleave because
ids differ, and within a segment the order is exactly ``sortx.sort``'s.
Cost is independent of the segment count or the length skew — a
1-element segment next to a 100M one costs the same as balanced
halves.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import Config, default_config
from ..runtime.launcher import profiled
from .extras import sort_kv_u64, sort_u64
from .sort import _check_keys, _to_radix_u32

__all__ = ["sort_segments", "sort_kv_segments"]


def _segment_ids(offsets, n: int):
    """Per-element segment index from an offsets vector.

    ``offsets`` is the CUB-style boundary vector: ``S+1`` nondecreasing
    ints with ``offsets[0] == 0`` and ``offsets[-1] == n``; segment i is
    ``[offsets[i], offsets[i+1])`` (empty segments allowed).
    """
    if offsets.ndim != 1 or offsets.shape[0] < 2:
        raise ValueError("offsets must be 1D with at least 2 entries "
                         "(S+1 boundaries for S segments)")
    if offsets.shape[0] - 1 > 0xFFFFFFFF:
        raise ValueError("too many segments")
    pos = jnp.arange(n, dtype=offsets.dtype)
    # side='right' - 1: element at a boundary belongs to the segment
    # that STARTS there (empty segments contribute no elements).
    return (jnp.searchsorted(offsets, pos, side="right") - 1).astype(
        jnp.uint32)


@profiled("sort_segments")
def sort_segments(keys, offsets, *, descending: bool = False,
                  config: Config | None = None):
    """Sort each ``keys[offsets[i]:offsets[i+1]]`` independently.

    ``keys``: 1D u32/i32/f32 (same dtype contract as ``sortx.sort``).
    ``offsets``: int boundaries, ``offsets[0]==0 <= ... <= offsets[-1]==n``
    (not validated under jit — a non-monotone vector gives an unspecified
    permutation). Returns keys with every segment sorted (descending
    inside each segment when ``descending=True``); segment boundaries are
    unchanged.
    """
    cfg = config or default_config()
    _check_keys(keys)
    n = keys.shape[0]
    if n <= 1:
        return keys
    seg = _segment_ids(offsets, n)
    k, undo = _to_radix_u32(keys)
    if descending:
        k = ~k
    _, lo = sort_u64(seg, k, config=cfg)
    return undo(~lo if descending else lo)


@profiled("sort_kv_segments")
def sort_kv_segments(keys, values, offsets, *, descending: bool = False,
                     config: Config | None = None):
    """Stable segmented key-value sort (values follow their keys).

    Within each segment, equal keys keep their original relative order
    (the ``sort_kv_u64`` composite carries an index tie-break stream).
    """
    cfg = config or default_config()
    _check_keys(keys)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    n = keys.shape[0]
    if n <= 1:
        return keys, values
    seg = _segment_ids(offsets, n)
    k, undo = _to_radix_u32(keys)
    if descending:
        k = ~k
    _, lo, v = sort_kv_u64(seg, k, values, config=cfg)
    return undo(~lo if descending else lo), v
