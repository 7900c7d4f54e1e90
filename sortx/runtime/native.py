"""ctypes bindings to the native C++ host sort (csrc/host_sort.cpp).

The host-backend analog of the reference's CPU path (``DeviceHost`` +
``RadixSort.cpp``): a fast native oracle for large-n verification, and the
engine behind ``reference`` when available. Falls back to the numpy oracle
if the shared library hasn't been built (``make -C csrc``, which writes
``build/libsortx_host.so``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["available", "host_sort", "host_sort_kv", "host_scan",
           "host_merge", "build_native"]

_REPO = os.path.join(os.path.dirname(__file__), "..", "..")
_CSRC = os.path.join(_REPO, "csrc")
_LIB_PATH = os.path.join(_REPO, "build", "libsortx_host.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.sortx_host_sort_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_int]
    lib.sortx_host_sort_kv_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64, ctypes.c_int]
    lib.sortx_host_exclusive_scan_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64]
    lib.sortx_host_exclusive_scan_u32.restype = ctypes.c_uint32
    if hasattr(lib, "sortx_host_merge_u32"):
        lib.sortx_host_merge_u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32)]
    _lib = lib
    return lib


def build_native(force: bool = False) -> bool:
    """Build the shared library (KernelBuilder compile-step analog).

    ``force`` rebuilds even if make's timestamps call the library up to
    date (a copied tree carries the copier's timestamps)."""
    global _lib
    try:
        subprocess.run(["make", "-C", _CSRC] + (["-B"] if force else []),
                       check=True, capture_output=True)
        _lib = None
        return _load() is not None
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def available() -> bool:
    return _load() is not None


def _u32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native library not built; run `make -C csrc` "
            "(or sortx.runtime.native.build_native())")
    return lib


def host_sort(keys: np.ndarray, sort_bits: int = 32) -> np.ndarray:
    """Stable native LSD sort; returns a new sorted array."""
    lib = _require()
    out = np.ascontiguousarray(keys, dtype=np.uint32).copy()
    lib.sortx_host_sort_u32(_u32ptr(out), out.shape[0], sort_bits)
    return out


def host_sort_kv(keys: np.ndarray, values: np.ndarray, sort_bits: int = 32):
    lib = _require()
    k = np.ascontiguousarray(keys, dtype=np.uint32).copy()
    v = np.ascontiguousarray(values, dtype=np.uint32).copy()
    lib.sortx_host_sort_kv_u32(_u32ptr(k), _u32ptr(v), k.shape[0], sort_bits)
    return k, v


def host_merge(keys: np.ndarray, offsets, values: np.ndarray | None = None):
    """Stable parallel k-way merge of sorted u32 runs.

    ``keys``: sorted runs laid out back-to-back; run r is
    ``keys[offsets[r]:offsets[r+1]]``. Returns the merged array (and the
    values array carried through the same permutation when given). The
    host half of the out-of-core sort (``sortx.sort_large``) — the
    reference's >max-alloc host-backed buffer analog (AdlCL.inl:373-378).
    """
    lib = _require()
    if not hasattr(lib, "sortx_host_merge_u32"):
        raise RuntimeError("libsortx_host.so is stale; run `make -C csrc`")
    k = np.ascontiguousarray(keys, dtype=np.uint32)
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    if off[-1] != k.shape[0]:
        raise ValueError("offsets[-1] must equal len(keys)")
    ko = np.empty_like(k)
    nullp = ctypes.POINTER(ctypes.c_uint32)()
    if values is not None:
        v = np.ascontiguousarray(values, dtype=np.uint32)
        if v.shape != k.shape:
            raise ValueError("values must match keys shape")
        vo = np.empty_like(v)
        lib.sortx_host_merge_u32(
            _u32ptr(k), _u32ptr(v),
            off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            off.shape[0] - 1, _u32ptr(ko), _u32ptr(vo))
        return ko, vo
    lib.sortx_host_merge_u32(
        _u32ptr(k), nullp,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        off.shape[0] - 1, _u32ptr(ko), nullp)
    return ko


def host_scan(x: np.ndarray):
    """Exclusive u32 scan; returns (out, total)."""
    lib = _require()
    xin = np.ascontiguousarray(x, dtype=np.uint32)
    out = np.empty_like(xin)
    total = lib.sortx_host_exclusive_scan_u32(_u32ptr(xin), _u32ptr(out),
                                              xin.shape[0])
    return out, np.uint32(total)
