"""Out-of-core sort + capacity contract (ops/out_of_core.py).

The reference transparently backs >max-alloc buffers in host memory
(Adl/CL/AdlCL.inl:373-378); sortx makes the capacity limit typed
(CapacityError) and provides sort_large / sort_kv_large: device-sorted
chunks + the native parallel k-way merge. CPU tests force multi-chunk
geometry with tiny chunk_elems; chip_smoke.py runs sort_large on the
GPU and tools/verify_oocore_2e30.py at 2^30 keys on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sortx
from sortx.ops import out_of_core as oc
from sortx.runtime import native
from sortx.utils.errors import CapacityError

needs_native = pytest.mark.usefixtures("native_lib")


@needs_native
def test_host_merge_matches_numpy(rng):
    runs = [np.sort(rng.randint(0, 2**32, size=s, dtype=np.uint32))
            for s in (1000, 1, 0, 4096, 333)]
    keys = np.concatenate(runs)
    off = np.cumsum([0] + [len(r) for r in runs])
    got = native.host_merge(keys, off)
    assert np.array_equal(got, np.sort(keys))


@needs_native
def test_host_merge_kv_stable(rng):
    # Duplicate-heavy keys; values = global position. A stable merge
    # keeps run order (= position order) for equal keys.
    runs = []
    vals = []
    pos = 0
    for s in (2048, 1024, 3000):
        k = np.sort(rng.randint(0, 13, size=s).astype(np.uint32))
        runs.append(k)
        vals.append(np.arange(pos, pos + s, dtype=np.uint32))
        pos += s
    keys = np.concatenate(runs)
    off = np.cumsum([0] + [len(r) for r in runs])
    ko, vo = native.host_merge(keys, off, values=np.concatenate(vals))
    assert np.array_equal(ko, np.sort(keys))
    # Per-key groups must have ascending positions... but ONLY the runs
    # are sorted, not the concatenation; build the expected stable order
    # explicitly: within each key, elements in (run, within-run) order.
    order = np.argsort(keys, kind="stable")
    # argsort(stable) of the concatenated runs = run-major for equal
    # keys only if the within-run order matches; runs are sorted, so it
    # does for the merged comparator (key, run, pos).
    assert np.array_equal(vo, np.concatenate(vals)[order])


@needs_native
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_sort_large_multichunk(rng, dtype):
    n = 100_003
    if dtype == np.uint32:
        k = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    elif dtype == np.int32:
        k = rng.randint(-2**31, 2**31, size=n).astype(np.int32)
    else:
        k = rng.randn(n).astype(np.float32)
    got = sortx.sort_large(k, chunk_elems=1 << 14)
    assert got.dtype == dtype
    assert np.array_equal(got, np.sort(k))


@needs_native
def test_sort_large_descending_and_partial_bits(rng):
    n = 50_000
    k = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    got = sortx.sort_large(k, descending=True, chunk_elems=1 << 14)
    assert np.array_equal(got, np.sort(k)[::-1])
    got = sortx.sort_large(k, 12, chunk_elems=1 << 14)
    order = np.argsort(k & 0xFFF, kind="stable")
    assert np.array_equal(got, k[order])


@needs_native
def test_sort_kv_large_stable(rng):
    n = 80_000
    k = rng.randint(0, 50, size=n).astype(np.uint32)
    v = np.arange(n, dtype=np.uint32)
    ks, vs = sortx.sort_kv_large(k, v, chunk_elems=1 << 14)
    order = np.argsort(k, kind="stable")
    assert np.array_equal(ks, k[order])
    assert np.array_equal(vs, v[order])


@needs_native
def test_sort_kv_large_float_values(rng):
    n = 30_000
    k = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    v = rng.randn(n).astype(np.float32)
    ks, vs = sortx.sort_kv_large(k, v, chunk_elems=1 << 14)
    order = np.argsort(k, kind="stable")
    assert vs.dtype == np.float32
    assert np.array_equal(vs, v[order])


def test_sort_large_validation():
    with pytest.raises(ValueError):
        sortx.sort_large(np.zeros((4, 4), np.uint32))
    with pytest.raises(ValueError):
        sortx.sort_large(np.zeros(8, np.int32), 12)  # partial needs u32
    with pytest.raises(TypeError):
        sortx.sort_large(np.zeros(8, np.uint8))


class _FakeDev:
    def __init__(self, kind="NVIDIA H100 80GB HBM3", platform="gpu",
                 limit=1 << 30):
        self.device_kind, self.platform, self._limit = kind, platform, limit

    def memory_stats(self):
        return {"bytes_limit": self._limit}


def test_capacity_error_raised(monkeypatch):
    """A fake 1GB H100 turns an oversized sort into a typed
    CapacityError naming sort_large — never an opaque allocator OOM."""
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDev()])
    with pytest.raises(CapacityError, match="sort_large"):
        oc.check_device_capacity(1 << 28, 4)
    # Fits: no raise.
    oc.check_device_capacity(1 << 24, 4)
    factor = oc._BYTES_PER_OPERAND_BYTE["NVIDIA H100 80GB HBM3"]
    assert oc.device_capacity_keys(4) == int((1 << 30) // (factor * 4))


@pytest.mark.parametrize("operand_bytes", [4, 8, 12, 16])
def test_capacity_estimate_scales_with_operand_bytes(monkeypatch,
                                                     operand_bytes):
    """The estimate is the measured bytes per operand byte: twice the
    operand bytes fit half the keys, and the keys-only u32 sort of the
    measured 2^27 fits an 80 GB card's default 75% allocator limit."""
    import jax

    limit = int(0.75 * 80e9)
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDev(limit=limit)])
    cap = oc.device_capacity_keys(operand_bytes)
    assert cap == int(limit // (3.05 * operand_bytes))
    assert cap >= 1 << 27
    assert oc.device_capacity_keys(4) >= cap


def test_capacity_unknown_device_is_an_error(monkeypatch):
    """No memory model for a card means an error, never a guess."""
    import jax

    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDev(kind="Some Other GPU")])
    with pytest.raises(ValueError, match="Some Other GPU"):
        oc.device_capacity_keys(4)
    with pytest.raises(ValueError, match="no sort memory model"):
        sortx.sort(jnp.zeros((16,), jnp.uint32))


def test_capacity_not_checked_on_cpu(monkeypatch):
    """The CPU backend has host memory and no device limit."""
    import jax

    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDev(kind="cpu", platform="cpu")])
    assert oc.device_capacity_keys(4) is None
    oc.check_device_capacity(1 << 40, 16)


def test_sort_paths_check_capacity(monkeypatch, rng):
    """sort and sort_kv ask for the operand bytes they sort: 4 for u32
    keys, 8 for partial bits (masked key + full key), key + value bytes
    for key-value sorts."""
    seen = []
    import importlib

    sort_mod = importlib.import_module("sortx.ops.sort")
    monkeypatch.setattr(sort_mod, "check_device_capacity",
                        lambda n, b: seen.append((n, b)))
    k = jnp.asarray(rng.randint(0, 2**32, size=64, dtype=np.uint32))
    sortx.sort(k)
    sortx.sort(k, 8)
    sortx.sort_kv(k, k)
    sortx.sort_kv(k, k.astype(jnp.float16))
    assert seen == [(64, 4), (64, 8), (64, 8), (64, 6)]


def test_sort_paths_check_capacity_64bit_keys(monkeypatch, rng):
    """64-bit keys are checked too: 12 operand bytes for sort, plus the
    value bytes for sort_kv, so an oversized 64-bit key-value sort
    raises CapacityError before it can run out of device memory."""
    seen = []
    import importlib

    sort_mod = importlib.import_module("sortx.ops.sort")
    monkeypatch.setattr(sort_mod, "check_device_capacity",
                        lambda n, b: seen.append((n, b)))
    with jax.enable_x64(True):
        k = jnp.asarray(rng.randint(0, 2**62, size=64, dtype=np.int64)
                        .astype(np.uint64))
        sortx.sort(k)
        sortx.sort_kv(k, k.astype(jnp.uint32))
        sortx.sort_kv(k, k)
    # sort's two 32-bit passes check their own 8 bytes as well.
    assert seen == [(64, 12), (64, 8), (64, 8), (64, 16), (64, 20)]


def test_capacity_error_64bit_key_value(monkeypatch):
    """The 64-bit key-value path raises the typed error on a card too
    small for it."""
    with jax.enable_x64(True):
        k = jnp.zeros((1 << 25,), jnp.uint64)
        v = jnp.zeros((1 << 25,), jnp.uint32)
        monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDev()])
        with pytest.raises(CapacityError, match="sort_large"):
            sortx.sort_kv(k, v)
