"""Beyond-reference convenience primitives built on the core sort.

The reference exposes only scan/sort/sort_kv; these are the standard
companions users expect from a sort library, built stably on the same
XLA sort (so they inherit its correctness guarantees).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Config
from ..runtime.launcher import profiled
from .sort import sort_kv
from .sort_xla import sort_multi_xla

__all__ = ["argsort", "lexsort", "sort_u64", "sort_kv_u64"]


@profiled("argsort")
def argsort(keys, sort_bits: int | None = None, *,
            descending: bool = False, config: Config | None = None):
    """Stable argsort: the permutation that sorts ``keys``.

    Equivalent to numpy's ``argsort(kind='stable')`` for u32/i32/f32
    keys (64-bit u64/i64/f64 too under x64 mode): a stable key-value
    sort whose values are the indices. ``descending=True`` reverses the
    key order; equal keys still keep ascending original positions
    (stable descending, like ``argsort(-keys)`` for ints).
    """
    from .sort import _check_keys, _resolve_sort_bits, _to_radix_u64

    _check_keys(keys, allow64=True)
    sort_bits = _resolve_sort_bits(keys, sort_bits, what="argsort")
    n = keys.shape[0]
    idx = jnp.arange(n, dtype=jnp.uint32)
    if sort_bits == 64:
        hi, lo, _ = _to_radix_u64(keys)
        if descending:
            hi, lo = ~hi, ~lo
        lo1, (hi1, i1) = sort_multi_xla(lo, (hi, idx))
        _, (_, i2) = sort_multi_xla(hi1, (lo1, i1))
        return i2.astype(jnp.int32)
    _, perm = sort_kv(keys, idx, sort_bits, descending=descending,
                      config=config)
    return perm.astype(jnp.int32)


@profiled("lexsort")
def lexsort(keys, *, descending: bool = False,
            config: Config | None = None):
    """Stable multi-column argsort — ``np.lexsort`` parity.

    ``keys`` is a sequence of equal-length 1D arrays; the LAST one is
    the primary sort key (numpy's convention). Returns the int32
    permutation that sorts the columns lexicographically; ties at every
    level keep their original order (stable). Columns may mix dtypes —
    each transforms independently by its natural order (u32/i32/f32,
    16-bit widening, and 64-bit u64/i64/f64 under x64 mode, which
    contribute a (hi, lo) word pair). ``descending=True`` reverses the
    lexicographic order; equal rows still keep ascending positions.

    One ``lax.sort`` with every column in the comparator (the index
    stream is the result) — no column is re-sorted, unlike numpy's
    column-by-column LSD passes. The reference library has no multi-key
    sort; this is the natural generalization of its KV pairs
    (``RadixSortKeyValueKernels.cl``).
    """
    from .sort import _check_key_dtype, _to_radix_u32, _to_radix_u64

    keys = tuple(keys)
    if not keys:
        raise ValueError("lexsort needs at least one key column")
    n = keys[0].shape[0]
    for k in keys:
        if k.ndim != 1:
            raise ValueError("lexsort expects 1D key columns")
        if k.shape[0] != n:
            raise ValueError("lexsort key columns must have equal length")
        _check_key_dtype(k.dtype, what="lexsort", allow64=True)

    from .sort import _DTYPES64

    streams = []
    for k in reversed(keys):               # primary key first
        if jnp.dtype(k.dtype) in _DTYPES64:
            hi, lo, _ = _to_radix_u64(k)
            streams += [hi, lo]
        else:
            streams.append(_to_radix_u32(k)[0])
    if descending:
        streams = [~s for s in streams]    # complement = reverse lex order
    nk = len(streams)
    idx = jnp.arange(n, dtype=jnp.uint32)
    if n <= 1:
        return idx.astype(jnp.int32)
    out = jax.lax.sort([*streams, idx], num_keys=nk, is_stable=True)
    return out[-1].astype(jnp.int32)


@profiled("sort_u64")
def sort_u64(hi, lo, *, descending: bool = False,
             config: Config | None = None):
    """Stable sort of 64-bit keys given as (hi, lo) u32 halves.

    Two reference-style LSD word passes (stable ``sort_kv`` by lo, then
    by hi). Returns sorted (hi, lo).
    """
    if hi.shape != lo.shape:
        raise ValueError("hi and lo must have the same shape")
    if hi.dtype != jnp.uint32 or lo.dtype != jnp.uint32:
        raise TypeError("sort_u64 expects uint32 hi/lo halves")
    if descending:
        # Complementing BOTH words reverses the 64-bit lexicographic
        # order; run ascending and complement back.
        hi, lo = ~hi, ~lo
    lo1, hi1 = sort_kv(lo, hi, config=config)
    hi2, lo2 = sort_kv(hi1, lo1, config=config)
    return (~hi2, ~lo2) if descending else (hi2, lo2)


@profiled("sort_kv_u64")
def sort_kv_u64(hi, lo, values, *, stable: bool = True,
                descending: bool = False,
                config: Config | None = None):
    """Stable 64-bit-key sort carrying a 32-bit payload.

    Returns (hi, lo, values) sorted by the 64-bit (hi,lo) key, stable:
    two 3-operand LSD passes. ``stable=False`` is accepted for API
    symmetry with ``sort_kv``; the result is stable either way.
    """
    if not (hi.shape == lo.shape == values.shape):
        raise ValueError("hi, lo, values must have the same shape")
    if hi.dtype != jnp.uint32 or lo.dtype != jnp.uint32:
        raise TypeError("sort_kv_u64 expects uint32 hi/lo halves")
    del stable
    if descending:
        hi, lo = ~hi, ~lo
    lo1, (hi1, v1) = sort_multi_xla(lo, (hi, values))
    h2, (l2, v2) = sort_multi_xla(hi1, (lo1, v1))
    if descending:
        h2, l2 = ~h2, ~l2
    return h2, l2, v2
