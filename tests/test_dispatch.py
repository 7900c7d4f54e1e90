"""The one dispatch resolver and the typed errors of removed options."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sortx
from sortx import config as config_mod
from sortx.ops import dispatch


@pytest.mark.parametrize("backend,n,expect", [
    ("gpu", 1 << 24, "triton"),
    ("gpu", 1 << 27, "triton"),
    ("gpu", (1 << 24) - 1, "xla"),
    ("gpu", 1 << 20, "xla"),
    ("cpu", 1 << 27, "xla"),
    ("cpu", 1 << 24, "xla"),
    ("cpu", 1 << 20, "xla"),
])
def test_scan_resolver(monkeypatch, backend, n, expect):
    """The Triton scan runs only on a GPU, and only from the measured
    size up."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert dispatch.resolve("scan", sortx.Config(), n) == expect


@pytest.mark.parametrize("backend,mode,native_ok,expect", [
    ("cpu", "auto", True, "sort"),
    ("gpu", "auto", True, "sort"),
    ("cpu", "rank", True, "rank"),
    ("gpu", "rank", False, "rank"),
    ("cpu", "native", True, "native"),
    ("cpu", "native", False, "sort"),
    ("gpu", "native", True, "sort"),
    ("cpu", "sort", True, "sort"),
])
def test_dist_merge_resolver(monkeypatch, backend, mode, native_ok, expect):
    from sortx.runtime import native

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(native, "available", lambda: native_ok)
    cfg = sortx.Config(dist_local_merge=mode)
    assert dispatch.resolve("dist_merge", cfg) == expect


@pytest.mark.parametrize("extra", ["values_u32", "values_f16",
                                   "full_key_and_values"])
def test_local_stable_sort_is_stable_order(rng, extra):
    """The per-shard sort (one composed 64-bit key, payloads by
    gather) gives the stable order of the masked key on every backend,
    with each further stream permuted alike."""
    ds = importlib.import_module("sortx.parallel.dist_sort")
    n = 5000
    full = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    mk = full & np.uint32(0xFF)                 # heavy ties
    order = np.argsort(mk, kind="stable")
    streams = [jnp.asarray(mk), jnp.arange(n, dtype=jnp.uint32)]
    expect = []
    if extra == "full_key_and_values":
        streams.append(jnp.asarray(full))
        expect.append(full[order])
    vals = np.arange(n, dtype=np.uint32)[::-1].copy()
    if extra == "values_f16":
        vals = rng.standard_normal(n).astype(np.float16)
    streams.append(jnp.asarray(vals))
    expect.append(vals[order])
    out = ds._local_stable_sort(streams)
    assert np.array_equal(np.asarray(out[0]), mk[order])
    assert np.array_equal(np.asarray(out[1]), order.astype(np.uint32))
    for got, exp in zip(out[2:], expect):
        assert got.dtype == exp.dtype
        assert np.array_equal(np.asarray(got), exp)


def test_resolver_rejects_unknown_op():
    with pytest.raises(ValueError, match="sort_magic"):
        dispatch.resolve("sort_magic", sortx.Config())


def test_resolver_branches_only_on_gpu_or_cpu():
    """Dispatch branches on what the input shows; the only backends it
    names are the two it was measured on."""
    import inspect
    import re

    src = inspect.getsource(dispatch)
    assert set(re.findall(r'backend [!=]= "(\w+)"', src)) == {"gpu", "cpu"}


@pytest.mark.parametrize("knob,value", [
    ("engine_log_block", 17), ("engine_tile_elems", 1 << 21),
    ("engine_buckets", 0), ("engine_min_n", 0), ("engine_headroom", 1.1),
    ("engine_chunk_elems", 1 << 14), ("engine_dma_slots", 4),
    ("engine_phase_sort", "xla"), ("interpret", True),
    ("scan_tile_elems", 1 << 18), ("scan_use_mxu", True),
    ("dist_exchange", "a2a"), ("engine", "pallas"), ("engine", "hybrid"),
    ("engine", "host"), ("engine", "auto"), ("bits_per_pass", 8),
])
def test_removed_knob_is_a_typed_error(knob, value):
    with pytest.raises(ValueError, match=f"{knob}=.*was removed"):
        sortx.Config(**{knob: value})


@pytest.mark.parametrize("field,value", [
    ("dist_local_merge", "tree"),
])
def test_removed_value_is_a_typed_error(field, value):
    with pytest.raises(ValueError, match=f"{field}='{value}'.*was removed"):
        sortx.Config(**{field: value})


@pytest.mark.parametrize("name", ["SORTX_ENGINE", "SORTX_INTERPRET"])
def test_removed_environment_variable_is_a_typed_error(name):
    with pytest.raises(ValueError, match=name):
        config_mod.check_removed_env({name: "1"})
    config_mod.check_removed_env({"SORTX_LOG_LEVEL": "1"})


def test_unknown_values_still_rejected():
    with pytest.raises(ValueError, match="auto\\|native\\|rank\\|sort"):
        sortx.Config(dist_local_merge="fast")
    with pytest.raises(ValueError, match="multiple of 1024"):
        sortx.Config(sort_tile_elems=1000)
    with pytest.raises(TypeError):
        sortx.Config(no_such_knob=1)


def test_valid_configs_and_replace():
    """Kept knobs construct, hash (jit static args) and go through
    dataclasses.replace, which re-enters the guarded __init__."""
    import dataclasses

    cfg = sortx.Config(dist_local_merge="rank", sort_tile_elems=2048)
    assert hash(cfg) == hash(sortx.Config(dist_local_merge="rank",
                                          sort_tile_elems=2048))
    assert dataclasses.replace(cfg, dist_local_merge="sort") \
        .dist_local_merge == "sort"
    with pytest.raises(ValueError, match="engine=.*was removed"):
        dataclasses.replace(cfg, engine="host")


@pytest.mark.parametrize("n", [1, 4097, 5000])
def test_scan_branches_agree(rng, n):
    """The two scan implementations the resolver chooses between give
    identical results: the cumsum branch, and the Triton kernel in
    interpret mode."""
    scan_mod = importlib.import_module("sortx.ops.scan")
    x = jnp.asarray(rng.randint(0, 2**31, size=n).astype(np.int32))
    for inclusive in (False, True):
        a, ta = scan_mod._scan_cumsum(x, inclusive=inclusive)
        b, tb = scan_mod._scan_triton(x, inclusive=inclusive,
                                      interpret=True)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert int(ta) == int(tb)
    np.testing.assert_array_equal(
        np.asarray(sortx.scan(x)),
        sortx.reference.exclusive_scan(np.asarray(x)))
