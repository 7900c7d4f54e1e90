"""Public sort API: keys-only and key-value stable LSD radix sort.

Replacement for ``Pprims::radixSort`` (both overloads,
``Tahoe/ParallelPrimitives/Pprims.h:37-41``, ``Pprims.cpp:200-406``).

Contract differences from the reference (all strict improvements):
  - no ``n % 256 == 0`` alignment requirement for keys-only sort
    (the reference asserts it, ``Pprims.cpp:327``); ragged n is handled by
    padding with 0xffffffff keys that sort to the tail and are sliced off —
    the same semantics the reference's KV path gets from CHECK_BOUNDARY
    (``RadixSortKeyValueKernels.cl:552-563``);
  - any ``sort_bits`` in 1..32 (the reference requires a multiple of 4,
    ``Pprims.cpp:330``);
  - the sort itself is XLA's ``lax.sort`` (``ops/sort_xla.py``), which
    the GPU backend hands to a library radix sort where it can.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, default_config
from ..runtime.launcher import profiled
from .out_of_core import check_device_capacity
from .sort_xla import sort_kv_xla, sort_xla

__all__ = ["sort", "sort_kv"]


# 16-bit key dtypes sort by exact monotone widening to their 32-bit
# counterpart (zero/sign-extend for ints; f16/bf16 -> f32 is exact), and
# the undo narrows back (every value round-trips exactly).
_WIDEN = {
    jnp.dtype(jnp.uint16): jnp.uint32,
    jnp.dtype(jnp.int16): jnp.int32,
    jnp.dtype(jnp.float16): jnp.float32,
    jnp.dtype(jnp.bfloat16): jnp.float32,
}


# 64-bit key dtypes (require jax x64 mode to exist as array dtypes).
# They sort as (hi, lo) u32 word pairs (ops/extras.py sort_u64).
_DTYPES64 = (jnp.dtype(np.uint64), jnp.dtype(np.int64),
             jnp.dtype(np.float64))


def _check_key_dtype(dtype, what: str = "sort", allow64: bool = False):
    if dtype in (jnp.uint32, jnp.int32, jnp.float32):
        return
    if jnp.dtype(dtype) in _WIDEN:
        return
    if jnp.dtype(dtype) in _DTYPES64:
        if allow64:
            return
        raise TypeError(f"{what} does not support 64-bit keys "
                        f"(got {dtype})")
    wide = " or 64-bit u64/i64/f64 [x64 mode]" if allow64 else ""
    raise TypeError(
        f"{what} supports u32/i32/f32 (or 16-bit u16/i16/f16/bf16"
        f"{wide}) keys, got {dtype}")


def _check_keys(keys, allow64: bool = False):
    if keys.ndim != 1:
        raise ValueError("sort expects a 1D key array")
    _check_key_dtype(keys.dtype, allow64=allow64)


def _to_radix_u32(keys):
    """Map keys to u32 so unsigned radix order == the natural key order.

    u32: identity (the reference's only key type). i32: flip the sign bit
    (two's-complement -> offset-binary). f32: the classic monotone float
    transform (flip all bits of negatives, sign bit of positives); total
    order with NaN at the extremes. 16-bit dtypes widen exactly first.
    Returns (u32_keys, undo_fn).
    """
    dt = keys.dtype
    wide = _WIDEN.get(jnp.dtype(dt))
    if wide is not None:
        k, undo_wide = _to_radix_u32(keys.astype(wide))
        return k, lambda u: undo_wide(u).astype(dt)
    if dt == jnp.uint32:
        return keys, lambda k: k
    if dt == jnp.int32:
        sign = jnp.uint32(0x80000000)
        return (keys.view(jnp.uint32) ^ sign), (
            lambda k: (k ^ sign).view(jnp.int32))
    # float32
    bits = keys.view(jnp.uint32)
    mask = jnp.where(bits >> 31 == 1, jnp.uint32(0xFFFFFFFF),
                     jnp.uint32(0x80000000))
    fwd = bits ^ mask

    def undo(k):
        m = jnp.where(k >> 31 == 0, jnp.uint32(0xFFFFFFFF),
                      jnp.uint32(0x80000000))
        return (k ^ m).view(jnp.float32)

    return fwd, undo


def _to_radix_u64(keys):
    """Map 64-bit keys to (hi, lo) u32 words so that unsigned
    lexicographic (hi, lo) order == the natural key order.

    u64: raw words. i64: flip the top sign bit (offset-binary). f64: the
    same monotone transform as f32 applied to the 64-bit image (flip all
    bits of negatives, sign bit of positives); total order with NaNs at
    the extremes. Returns (hi, lo, undo_fn) with undo_fn(hi, lo) ->
    original dtype. Word extraction is arithmetic (shift/truncate), so
    it is endianness-independent.
    """
    dt = keys.dtype
    if dt == jnp.dtype(np.float64):
        # Bitcast straight to u32 word pairs (minor dim = words, least
        # significant first — XLA bitcast-convert semantics, pinned by
        # test_sort_64bit_roundtrip_extremes on every backend).
        w = jax.lax.bitcast_convert_type(keys, jnp.uint32)
        lo, hi = w[..., 0], w[..., 1]
    else:
        u = jax.lax.bitcast_convert_type(keys, jnp.uint64)
        hi = (u >> jnp.uint64(32)).astype(jnp.uint32)
        lo = u.astype(jnp.uint32)      # truncating cast = low word
    sign = jnp.uint32(0x80000000)
    if dt == jnp.dtype(np.uint64):
        fwd_hi, fwd_lo = hi, lo
        undo_words = lambda h, l: (h, l)
    elif dt == jnp.dtype(np.int64):
        fwd_hi, fwd_lo = hi ^ sign, lo
        undo_words = lambda h, l: (h ^ sign, l)
    else:                              # float64
        neg = hi >> 31 == 1
        fwd_hi = hi ^ jnp.where(neg, jnp.uint32(0xFFFFFFFF), sign)
        fwd_lo = lo ^ jnp.where(neg, jnp.uint32(0xFFFFFFFF),
                                jnp.uint32(0))

        def undo_words(h, l):
            was_neg = h >> 31 == 0     # negatives map below the sign bit
            return (h ^ jnp.where(was_neg, jnp.uint32(0xFFFFFFFF), sign),
                    l ^ jnp.where(was_neg, jnp.uint32(0xFFFFFFFF),
                                  jnp.uint32(0)))

    def undo(h, l):
        h, l = undo_words(h, l)
        if dt == jnp.dtype(np.float64):
            # same u32-pair form as the forward transform (no u64 hop)
            return jax.lax.bitcast_convert_type(
                jnp.stack([l, h], axis=-1), jnp.float64)
        w = ((h.astype(jnp.uint64) << jnp.uint64(32))
             | l.astype(jnp.uint64))
        return jax.lax.bitcast_convert_type(w, dt)

    return fwd_hi, fwd_lo, undo


def _resolve_sort_bits(keys, sort_bits, what: str = "sort"):
    """None -> the key dtype's full width; validate the explicit cases."""
    is64 = jnp.dtype(keys.dtype) in _DTYPES64
    if sort_bits is None:
        return 64 if is64 else 32
    if is64:
        if sort_bits != 64:
            raise ValueError(f"{what}: 64-bit keys sort on the full 64 "
                             f"bits (sort_bits=64 or None), got "
                             f"{sort_bits}")
        return 64
    if not (1 <= sort_bits <= 32):
        raise ValueError("sort_bits must be in 1..32")
    if keys.dtype != jnp.uint32 and sort_bits != 32:
        raise ValueError("partial sort_bits requires uint32 keys "
                         "(the reference's contract, Pprims.cpp:253)")
    return sort_bits


def _order_mask(sort_bits: int):
    """All-ones over the participating key bits (for descending flips)."""
    return jnp.uint32(0xFFFFFFFF if sort_bits >= 32
                      else (1 << sort_bits) - 1)


@profiled("sort")
def sort(keys, sort_bits: int | None = None, *, descending: bool = False,
         config: Config | None = None):
    """Stable LSD radix sort of keys by their low ``sort_bits`` bits.

    Analog of ``Pprims::radixSort(Buffer<u32>&, n, sortBits)``
    (``Pprims.cpp:304-406``), extended beyond the reference's u32-only
    contract: int32 keys sort in natural signed order and float32 keys in
    float order (monotone bit transforms; NaNs order by sign at the
    extremes). 16-bit keys widen exactly; 64-bit keys (u64/i64/f64,
    requires jax x64 mode) sort as (hi, lo) u32 word pairs.
    ``sort_bits=None`` means the full key width; partial widths need
    uint32 keys.

    ``descending=True`` reverses the order (stable: equal keys keep
    their original relative order) at the cost of two elementwise
    passes — the sort runs ascending on the complemented radix key,
    so a reverse-sorted input still hits the presorted fast path.
    """
    cfg = config or default_config()
    _check_keys(keys, allow64=True)
    sort_bits = _resolve_sort_bits(keys, sort_bits)
    n = keys.shape[0]
    if n <= 1:
        return keys

    if sort_bits == 64:
        from .extras import sort_u64

        check_device_capacity(n, 12)
        hi, lo, undo64 = _to_radix_u64(keys)
        h2, l2 = sort_u64(hi, lo, descending=descending, config=cfg)
        return undo64(h2, l2)

    k, undo = _to_radix_u32(keys)
    if descending:
        k = k ^ _order_mask(sort_bits)

    check_device_capacity(n, 4 if sort_bits >= 32 else 8)
    out = sort_xla(k, sort_bits)
    if descending:
        out = out ^ _order_mask(sort_bits)
    return undo(out)


@profiled("sort_kv")
def sort_kv(keys, values, sort_bits: int | None = None, *,
            stable: bool = True, descending: bool = False,
            config: Config | None = None):
    """Stable key-value LSD radix sort (sorts on keys; values follow).

    Analog of ``Pprims::radixSort(Buffer<uint2>&, n)``
    (``Pprims.cpp:200-302``). Values may be any 32-bit dtype; keys may
    also be 64-bit (u64/i64/f64, x64 mode, see ``sort``).
    ``stable=False`` permits unspecified ordering of values under equal
    keys (beyond-reference; XLA's sort is stable either way, and a
    stable result is a valid unstable result).
    """
    cfg = config or default_config()
    _check_keys(keys, allow64=True)
    sort_bits = _resolve_sort_bits(keys, sort_bits)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    n = keys.shape[0]
    if n <= 1:
        return keys, values

    if sort_bits == 64:
        from .extras import sort_kv_u64

        # The keys-only 64-bit count of 12 operand bytes, plus the
        # payload that rides both passes.
        check_device_capacity(n, 12 + values.dtype.itemsize)
        hi, lo, undo64 = _to_radix_u64(keys)
        h2, l2, v2 = sort_kv_u64(hi, lo, values, stable=stable,
                                 descending=descending, config=cfg)
        return undo64(h2, l2), v2

    k, undo = _to_radix_u32(keys)
    if descending:
        k = k ^ _order_mask(sort_bits)

    check_device_capacity(
        n, (4 if sort_bits >= 32 else 8) + values.dtype.itemsize)
    ks, vs = sort_kv_xla(k, values, sort_bits)
    if descending:
        ks = ks ^ _order_mask(sort_bits)
    return undo(ks), vs
