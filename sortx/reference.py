"""CPU golden reference implementations (the correctness oracle).

Re-imagination of the reference's serial CPU sort
(``Tahoe/Algorithm/Sort/RadixSort.cpp:10-104``) and the inline running-sum scan
oracle used by its unit tests (``UnitTest/main.cpp:193-199``). These are the
trusted implementations every device path is validated against, bit-exactly.

Contracts mirrored from the reference:
  - LSD radix sort, 8 bits per pass, 256 counting tables
    (``RadixSort.h:39-43``) — stable by construction.
  - Key-value pairs sort on the key only; values ride along
    (``RadixSort.cpp:10-56``, ``SortData::operator<`` on ``m_key``).
  - Exclusive prefix scan with optional grand total
    (``Pprims.h:35``, ``UnitTest/main.cpp:193-199``).

Implemented with numpy (vectorized counting sort per pass) rather than a
scalar loop — identical output, orders of magnitude faster for the 2^27-key
oracle runs used by the benchmarks.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "radix_sort",
    "radix_sort_kv",
    "exclusive_scan",
    "BITS_PER_PASS",
    "NUM_TABLES",
]

# Reference: Tahoe/Algorithm/Sort/RadixSort.h:39-43
BITS_PER_PASS = 8
NUM_TABLES = 1 << BITS_PER_PASS


def _as_u32(x) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype in (np.int32, np.uint32):
        return x.view(np.uint32) if x.dtype == np.int32 else x
    raise TypeError(f"expected 32-bit integer keys, got {x.dtype}")


def _native():
    try:
        from .runtime import native
        return native if native.available() else None
    except Exception:
        return None


def radix_sort(keys, sort_bits: int = 32) -> np.ndarray:
    """Stable LSD radix sort of u32 keys on the low ``sort_bits`` bits.

    Matches ``RadixSort::sort(u32*, int)`` (``RadixSort.cpp:58-104``) and the
    partial-bits contract of ``Pprims::radixSort`` (``Pprims.cpp:253``):
    keys are ordered by their low ``sort_bits`` bits only; ties (equal low
    bits) keep their input order. Uses the native C++ oracle
    (``csrc/host_sort.cpp``) when built; numpy otherwise — identical output.
    """
    nat = _native()
    if nat is not None:
        return nat.host_sort(_as_u32(keys), sort_bits)
    keys = _as_u32(keys).copy()
    if sort_bits <= 0:
        return keys
    for shift in range(0, sort_bits, BITS_PER_PASS):
        width = min(BITS_PER_PASS, sort_bits - shift)
        digit = (keys >> np.uint32(shift)) & np.uint32((1 << width) - 1)
        # np.argsort(kind="stable") on the digit = one stable counting pass.
        order = np.argsort(digit, kind="stable")
        keys = keys[order]
    return keys


def radix_sort_kv(keys, values, sort_bits: int = 32):
    """Stable key-value LSD radix sort; sorts on keys, values follow.

    Matches ``RadixSort::sort(SortData*, int)`` (``RadixSort.cpp:10-56``).
    """
    keys = _as_u32(keys).copy()
    values = np.asarray(values).copy()
    if keys.shape != values.shape:
        raise ValueError("keys and values must have the same shape")
    nat = _native()
    if nat is not None and values.dtype.itemsize == 4:
        k, v32 = nat.host_sort_kv(keys, values.view(np.uint32), sort_bits)
        return k, v32.view(values.dtype)
    for shift in range(0, sort_bits, BITS_PER_PASS):
        width = min(BITS_PER_PASS, sort_bits - shift)
        digit = (keys >> np.uint32(shift)) & np.uint32((1 << width) - 1)
        order = np.argsort(digit, kind="stable")
        keys = keys[order]
        values = values[order]
    return keys, values


def exclusive_scan(x, with_total: bool = False):
    """Exclusive prefix sum with int32 wraparound semantics.

    Matches the test oracle at ``UnitTest/main.cpp:193-199`` and the
    ``sum`` output of ``Pprims::scan`` (``Pprims.cpp:164-167``). Sums wrap
    modulo 2^32 exactly as the reference's ``u32`` arithmetic does.
    """
    x = np.asarray(x)
    u = x.astype(np.uint64)
    total = np.uint32(u.sum() & np.uint64(0xFFFFFFFF))
    out = (np.cumsum(u) - u) & np.uint64(0xFFFFFFFF)
    out = out.astype(np.uint32).astype(x.dtype, copy=False)
    if with_total:
        return out, total.astype(x.dtype) if x.dtype != np.uint32 else total
    return out
