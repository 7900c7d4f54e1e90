"""Out-of-core sort: host-staged chunked device sorts + native k-way merge.

Analog of the reference's >max-alloc host-backed buffers
(``Adl/CL/AdlCL.inl:373-378``): allocations beyond device memory live in
host RAM and stream through the device in chunks. Here the device sorts
chunks that fit its memory and the multithreaded native merge
(``csrc/host_sort.cpp`` ``sortx_host_merge_u32``) assembles the runs on
the host — so ``n`` is bounded by host RAM, not device memory.

Also home of the typed capacity contract: ``check_device_capacity``
raises ``CapacityError`` (with the computed limit and a pointer at
``sort_large``) instead of letting an oversized single-device sort die
in an opaque allocator error.
"""

from __future__ import annotations

import numpy as np

from ..config import Config
from ..runtime.launcher import profiled
from ..utils.errors import CapacityError

__all__ = ["sort_large", "sort_kv_large", "check_device_capacity",
           "device_capacity_keys"]


def _np_to_radix_u32(keys: np.ndarray):
    """numpy mirror of ops.sort._to_radix_u32 (u32/i32/f32 -> u32)."""
    dt = keys.dtype
    if dt == np.uint32:
        return keys, lambda k: k
    if dt == np.int32:
        sign = np.uint32(0x80000000)
        return keys.view(np.uint32) ^ sign, (
            lambda k: (k ^ sign).view(np.int32))
    if dt == np.float32:
        bits = keys.view(np.uint32)
        mask = np.where(bits >> 31 == 1, np.uint32(0xFFFFFFFF),
                        np.uint32(0x80000000))
        fwd = bits ^ mask

        def undo(k):
            m = np.where(k >> 31 == 0, np.uint32(0xFFFFFFFF),
                         np.uint32(0x80000000))
            return (k ^ m).view(np.float32)

        return fwd, undo
    raise TypeError(f"sort_large supports uint32/int32/float32 keys, "
                    f"got {dt}")


def _device_sort_u32(chunk: np.ndarray, sort_bits: int,
                     config: Config | None) -> np.ndarray:
    import jax.numpy as jnp

    from .sort import sort as _sort

    return np.asarray(_sort(jnp.asarray(chunk), sort_bits, config=config))


def _device_sort_kv_u32(k: np.ndarray, v: np.ndarray,
                        config: Config | None):
    import jax.numpy as jnp

    from .sort import sort_kv as _sort_kv

    ks, vs = _sort_kv(jnp.asarray(k), jnp.asarray(v), config=config)
    return np.asarray(ks), np.asarray(vs)


def _chunk_offsets(n: int, chunk_elems: int) -> np.ndarray:
    bounds = list(range(0, n, chunk_elems)) + [n]
    return np.asarray(bounds, dtype=np.int64)


@profiled("sort_large")
def sort_large(keys, sort_bits: int = 32, *, descending: bool = False,
               chunk_elems: int = 1 << 27,
               config: Config | None = None) -> np.ndarray:
    """Stable sort of a host-resident array of any size that fits RAM.

    ``keys``: 1D numpy (or array-like) of u32/i32/f32. Each
    ``chunk_elems`` slice is sorted on the device (the same engine as
    ``sortx.sort``), then the sorted runs are merged by the native
    parallel k-way merge. Ordering contract is identical to
    ``sortx.sort`` (stable, descending = stable reverse, partial
    ``sort_bits`` low-bit order for u32 keys).
    """
    keys_np = np.ascontiguousarray(np.asarray(keys))
    if keys_np.ndim != 1:
        raise ValueError("sort_large expects a 1D array")
    if not (1 <= sort_bits <= 32):
        raise ValueError("sort_bits must be in 1..32")
    if sort_bits != 32 and keys_np.dtype != np.uint32:
        raise ValueError("partial sort_bits requires uint32 keys "
                         "(the reference's contract, Pprims.cpp:253)")
    n = keys_np.shape[0]
    ku, undo = _np_to_radix_u32(keys_np)
    omask = np.uint32(0xFFFFFFFF if sort_bits >= 32
                      else (1 << sort_bits) - 1)
    if descending:
        ku = ku ^ omask
    off = _chunk_offsets(n, chunk_elems)
    if len(off) <= 2:
        out = _device_sort_u32(ku, sort_bits, config)
    else:
        runs = np.empty_like(ku)
        for i in range(len(off) - 1):
            lo, hi = int(off[i]), int(off[i + 1])
            runs[lo:hi] = _device_sort_u32(ku[lo:hi], sort_bits, config)
        from ..runtime import native

        if sort_bits >= 32:
            out = native.host_merge(runs, off)
        else:
            # Merge by the masked key, carrying the full key as the
            # payload: run order == input order keeps the merge stable
            # for equal masked keys (the partial-bits contract).
            _, out = native.host_merge(runs & omask, off, values=runs)
    if descending:
        out = out ^ omask
    return undo(out)


@profiled("sort_kv_large")
def sort_kv_large(keys, values, *, descending: bool = False,
                  chunk_elems: int = 1 << 27,
                  config: Config | None = None):
    """Stable key-value out-of-core sort (full 32 sort bits).

    Values may be any 4-byte dtype (ride the merge as u32 views).
    """
    keys_np = np.ascontiguousarray(np.asarray(keys))
    vals_np = np.ascontiguousarray(np.asarray(values))
    if keys_np.shape != vals_np.shape or keys_np.ndim != 1:
        raise ValueError("keys and values must be equal-shape 1D arrays")
    if vals_np.dtype.itemsize != 4:
        raise TypeError("sort_kv_large requires 4-byte value dtypes")
    n = keys_np.shape[0]
    ku, undo = _np_to_radix_u32(keys_np)
    if descending:
        ku = ku ^ np.uint32(0xFFFFFFFF)
    vu = (vals_np if vals_np.dtype == np.uint32
          else vals_np.view(np.uint32))
    off = _chunk_offsets(n, chunk_elems)
    if len(off) <= 2:
        ko, vo = _device_sort_kv_u32(ku, vu, config)
    else:
        kr = np.empty_like(ku)
        vr = np.empty_like(vu)
        for i in range(len(off) - 1):
            lo, hi = int(off[i]), int(off[i + 1])
            kr[lo:hi], vr[lo:hi] = _device_sort_kv_u32(
                ku[lo:hi], vu[lo:hi], config)
        from ..runtime import native

        ko, vo = native.host_merge(kr, off, values=vr)
    if descending:
        ko = ko ^ np.uint32(0xFFFFFFFF)
    return undo(ko), vo.view(vals_np.dtype)


# Device bytes a sort of n elements takes, per byte of the operands it
# sorts (input, output, and CUB's double buffer and scratch), by
# device_kind. From compiled.memory_analysis() at n = 2^27 on an NVIDIA
# H100 80GB HBM3 (400 W power limit): u32 keys 12.14 B/key (4 operand
# bytes), stable u32/u32 key-value 24.16 (8), 4-bit partial keys 24.16
# (8), u32 keys with u64 values 36.19 (12), and u64 keys — two 32-bit
# passes — 36.16, which ops.sort counts as 12 operand bytes.
_BYTES_PER_OPERAND_BYTE = {"NVIDIA H100 80GB HBM3": 3.05}


def device_capacity_keys(operand_bytes: int = 4) -> int | None:
    """Largest n a single-device sort of ``operand_bytes`` per element
    fits in, or None on the CPU backend (host memory, no device limit).

    Raises ValueError on an accelerator with no measured memory model.
    """
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return None
    factor = _BYTES_PER_OPERAND_BYTE.get(dev.device_kind)
    if factor is None:
        raise ValueError(
            f"no sort memory model for device {dev.device_kind!r}; "
            f"measure one and add it to "
            f"sortx.ops.out_of_core._BYTES_PER_OPERAND_BYTE")
    limit = dev.memory_stats()["bytes_limit"]
    return int(limit // (factor * operand_bytes))


def check_device_capacity(n: int, operand_bytes: int = 4) -> None:
    """Raise ``CapacityError`` if a single-device sort of n elements of
    ``operand_bytes`` each cannot fit.

    Called from the sort dispatch. The analog of the reference's
    transparent host-backed fallback — made explicit and typed, with
    ``sort_large`` as the documented escape hatch.
    """
    cap = device_capacity_keys(operand_bytes)
    if cap is not None and n > cap:
        raise CapacityError(
            f"sort of n={n} ({operand_bytes} operand bytes per element) "
            f"fits at most n={cap} on this device; use sortx.sort_large "
            f"(host-staged chunked sort) for beyond-device-memory inputs")
