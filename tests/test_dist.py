"""Distributed sort tests on a multi-device mesh.

Runs on the 8-virtual-device CPU mesh by default (conftest sets
``--xla_force_host_platform_device_count=8``); the ``gpu``-marked cases
run on the cards of a multi-GPU machine. Verifies bit-exact agreement
with the golden oracle — including ordering of equal keys across shard
boundaries (stability through the shuffle, SURVEY §7 "bit-exactness
across meshes").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sortx
from sortx import reference
from sortx.parallel import dist_sort, dist_sort_kv, make_sort_mesh, shard_1d

needs_multi = pytest.mark.usefixtures("multi_device")


def _mesh():
    return make_sort_mesh()


@needs_multi
@pytest.mark.parametrize("n", [1024, 4096, 65_536, 1_000_000])
def test_dist_sort_uniform(rng, n):
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    mesh = _mesh()
    got = np.asarray(dist_sort(jnp.asarray(keys), mesh=mesh))
    assert np.array_equal(got, reference.radix_sort(keys))


@needs_multi
def test_dist_sort_ragged_n(rng):
    for n in (1, 13, 1000, 12_345):
        keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
        got = np.asarray(dist_sort(jnp.asarray(keys), mesh=_mesh()))
        assert np.array_equal(got, reference.radix_sort(keys)), n


@needs_multi
def test_dist_sort_skew_all_equal():
    """The pathological all-to-one-digit case from BASELINE.json: every key
    identical — splitters must partition by rank, not value."""
    n = 100_000
    keys = np.full(n, 0xABCD1234, dtype=np.uint32)
    got = np.asarray(dist_sort(jnp.asarray(keys), mesh=_mesh()))
    assert np.array_equal(got, keys)


@needs_multi
def test_dist_sort_skew_two_values(rng):
    n = 65_536
    keys = (rng.randint(0, 2, size=n) * 0xFFFFFFFF).astype(np.uint32)
    got = np.asarray(dist_sort(jnp.asarray(keys), mesh=_mesh()))
    assert np.array_equal(got, reference.radix_sort(keys))


@needs_multi
def test_dist_sort_presorted_and_reversed(rng):
    base = np.sort(rng.randint(0, 2**32, size=65_536, dtype=np.uint32))
    for keys in (base, base[::-1].copy()):
        got = np.asarray(dist_sort(jnp.asarray(keys), mesh=_mesh()))
        assert np.array_equal(got, base)


@needs_multi
def test_dist_sort_kv_stability(rng):
    """Equal keys spanning shards must keep original global index order."""
    n = 50_000
    keys = rng.randint(0, 64, size=n).astype(np.uint32)  # heavy duplication
    vals = np.arange(n, dtype=np.uint32)
    gk, gv = reference.radix_sort_kv(keys, vals)
    ks, vs = dist_sort_kv(jnp.asarray(keys), jnp.asarray(vals), mesh=_mesh())
    assert np.array_equal(np.asarray(ks), gk)
    assert np.array_equal(np.asarray(vs), gv)


@needs_multi
def test_dist_sort_kv_partial_bits(rng):
    n = 30_000
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    gk, gv = reference.radix_sort_kv(keys, vals, sort_bits=8)
    ks, vs = dist_sort_kv(jnp.asarray(keys), jnp.asarray(vals), 8,
                          mesh=_mesh())
    assert np.array_equal(np.asarray(ks), gk)
    assert np.array_equal(np.asarray(vs), gv)


@needs_multi
def test_dist_sort_kv_value_dtypes(rng):
    """Values of any width ride the distributed sort: 4-byte dtypes as
    a u32 view, other widths as they are (regression: a blanket
    .view(u32) once changed the stream length for f16/i64 values and
    crashed)."""
    n = 16_000
    keys = rng.randint(0, 256, size=n).astype(np.uint32)
    mesh = _mesh()
    for vals in (rng.randn(n).astype(np.float32),
                 rng.randn(n).astype(np.float16),
                 rng.randint(-2**15, 2**15, size=n).astype(np.int16),
                 rng.randint(0, 255, size=n).astype(np.uint8)):
        ks, vs = dist_sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                              mesh=mesh)
        order = np.argsort(keys, kind="stable")
        assert np.asarray(vs).dtype == vals.dtype
        assert np.array_equal(np.asarray(ks), keys[order]), vals.dtype
        assert np.array_equal(np.asarray(vs), vals[order]), vals.dtype


@needs_multi
def test_dist_sort_sharded_input(rng):
    """Input already sharded over the mesh stays device-resident."""
    n = 32_768
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    mesh = _mesh()
    sharded = shard_1d(jnp.asarray(keys), mesh)
    got = np.asarray(dist_sort(sharded, mesh=mesh))
    assert np.array_equal(got, reference.radix_sort(keys))


@needs_multi
def test_dist_sort_max_keys_vs_padding(rng):
    """Real 0xFFFFFFFF keys must survive (padding uses the same value and
    must be sliced off, not confused with data)."""
    n = 10_007
    keys = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    keys[rng.randint(0, n, size=100)] = 7
    got = np.asarray(dist_sort(jnp.asarray(keys), mesh=_mesh()))
    assert np.array_equal(got, reference.radix_sort(keys))


@needs_multi
def test_dist_sort_float32(rng):
    keys = np.concatenate([
        rng.randn(20_000).astype(np.float32),
        np.array([np.inf, -np.inf, 0.0, -0.0], np.float32),
    ])
    got = np.asarray(dist_sort(jnp.asarray(keys), mesh=_mesh()))
    assert np.array_equal(got, np.sort(keys))


@needs_multi
def test_dist_sort_int32_signed(rng):
    keys = rng.randint(-2**31, 2**31, size=30_000).astype(np.int32)
    got = np.asarray(dist_sort(jnp.asarray(keys), mesh=_mesh()))
    assert np.array_equal(got, np.sort(keys))


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.float16])
def test_dist_sort_16bit(rng, dtype):
    # 16-bit keys ride the same exact monotone widening the single-chip
    # API uses (ops/sort.py _WIDEN); output narrows back to the input
    # dtype.
    if dtype == np.float16:
        keys = (rng.standard_normal(9_000) * 8).astype(np.float16)
    elif dtype == np.int16:
        keys = rng.randint(-2**15, 2**15, size=9_000).astype(np.int16)
    else:
        keys = rng.randint(0, 2**16, size=9_000).astype(np.uint16)
    got = np.asarray(dist_sort(jnp.asarray(keys), mesh=_mesh()))
    assert got.dtype == dtype
    assert np.array_equal(got, np.sort(keys))


def test_dist_sort_single_device_mesh(rng):
    """D=1 mesh short-circuits to the single-chip engine."""
    keys = rng.randint(0, 2**32, size=10_000, dtype=np.uint32)
    mesh = make_sort_mesh(1)
    got = np.asarray(dist_sort(jnp.asarray(keys), mesh=mesh))
    assert np.array_equal(got, reference.radix_sort(keys))
    vals = np.arange(10_000, dtype=np.uint32)
    ks, vs = dist_sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                          mesh=make_sort_mesh(1))
    gk, gv = reference.radix_sort_kv(keys, vals)
    assert np.array_equal(np.asarray(ks), gk)
    assert np.array_equal(np.asarray(vs), gv)


def test_dist_sort_validates_args(rng):
    """ADVICE.md: dist entry points enforce the same contract as sortx.sort."""
    import pytest

    mesh = make_sort_mesh(1)
    f = jnp.asarray(rng.randn(64).astype(np.float32))
    with pytest.raises(ValueError):
        dist_sort(f, sort_bits=8, mesh=mesh)
    with pytest.raises(ValueError):
        dist_sort(jnp.zeros((64,), jnp.uint32), sort_bits=0, mesh=mesh)
    with pytest.raises(TypeError):
        dist_sort(jnp.zeros((64,), jnp.uint8), mesh=mesh)
    with pytest.raises(ValueError):
        dist_sort(jnp.zeros((8, 8), jnp.uint32), mesh=mesh)
    with pytest.raises(ValueError):
        dist_sort_kv(jnp.zeros((64,), jnp.uint32),
                     jnp.zeros((32,), jnp.uint32), mesh=mesh)


@needs_multi
def test_dist_sort_padded_scale_safe(rng):
    """Padded API: evenly sharded result, pads at tail, O(n/D)/device."""
    from sortx.parallel import dist_sort_padded, dist_sort_kv_padded

    mesh = _mesh()
    d = mesh.shape["x"]
    n = d * 1000 + 123
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    padded, pad = dist_sort_padded(jnp.asarray(keys), mesh=mesh)
    m = -(-n // d)
    assert padded.shape == (d * m,) and pad == d * m - n
    out = np.asarray(padded)
    assert np.array_equal(out[:n], np.sort(keys))
    assert np.all(out[n:] == 0xFFFFFFFF)
    # every device holds exactly one even shard (never the full array)
    shapes = {s.data.shape for s in padded.addressable_shards}
    assert shapes == {(m,)}

    vals = np.arange(n, dtype=np.uint32)
    ks, vs, pad2 = dist_sort_kv_padded(jnp.asarray(keys), jnp.asarray(vals),
                                       mesh=mesh)
    assert pad2 == pad
    gk, gv = reference.radix_sort_kv(keys, vals)
    assert np.array_equal(np.asarray(ks)[:n], gk)
    assert np.array_equal(np.asarray(vs)[:n], gv)
    assert {s.data.shape for s in ks.addressable_shards} == {(m,)}


@needs_multi
def test_dist_sort_ragged_not_replicated(rng):
    """Round-1 weak #4: the ragged [n] result must not be replicated on
    every device (one device holds it; uneven sharding is unrepresentable
    in JAX)."""
    mesh = _mesh()
    d = mesh.shape["x"]
    n = d * 1000 + 7
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    out = dist_sort(jnp.asarray(keys), mesh=mesh)
    assert out.shape == (n,)
    assert np.array_equal(np.asarray(out), np.sort(keys))
    assert len(out.sharding.device_set) == 1, (
        "ragged output replicated on every device")


@needs_multi
def test_dist_exchange_witness(rng):
    import importlib
    ds_mod = importlib.import_module("sortx.parallel.dist_sort")

    mesh = _mesh()
    keys = rng.randint(0, 2**32, size=8000, dtype=np.uint32)
    dist_sort(jnp.asarray(keys), mesh=mesh)  # CPU mesh -> dense
    assert ds_mod.last_exchange == "dense"
    dist_sort(jnp.asarray(keys[:100]), mesh=make_sort_mesh(1))
    assert ds_mod.last_exchange == "single"


@needs_multi
@pytest.mark.parametrize("case", ["keys", "kv", "kv16", "equal"])
def test_dist_rank_merge_matches_sort_merge(rng, case):
    """Round-4: the step-5 rank merge (searchsorted co-ranking of the d
    received runs, the "absorbed merge" from DESIGN_NOTES' ICI
    projection) is bit-identical to the full re-sort path on every
    workload class, and the witness reports which ran."""
    import importlib
    ds_mod = importlib.import_module("sortx.parallel.dist_sort")

    mesh = _mesh()
    n = 20_000
    keys = rng.randint(0, 2**32, size=n - 13, dtype=np.uint32)  # ragged too
    vals = np.arange(n - 13, dtype=np.uint32)
    if case == "equal":
        keys = np.full(n, 0xFFFFFFFF, np.uint32)
        vals = np.arange(n, dtype=np.uint32)
    sort_bits = 16 if case == "kv16" else 32
    if case == "kv16":
        # Narrow low-16 range forces masked-key ties while the ignored
        # high bits stay wild (the masked comparator must break ties by
        # position, not by full key).
        keys = (keys & ~np.uint32(0xFFFF)) | (keys & np.uint32(7))
    out = {}
    for mode in ("sort", "rank"):
        cfg = sortx.Config(dist_local_merge=mode)
        if case == "keys":
            out[mode] = (np.asarray(dist_sort(jnp.asarray(keys),
                                              mesh=mesh, config=cfg)),)
        else:
            out[mode] = tuple(np.asarray(x) for x in dist_sort_kv(
                jnp.asarray(keys), jnp.asarray(vals), sort_bits,
                mesh=mesh, config=cfg))
        assert ds_mod.last_local_merge == mode
    for a, b in zip(out["sort"], out["rank"]):
        np.testing.assert_array_equal(a, b)


@needs_multi
def test_dist_native_merge_matches_sort_merge(rng, native_lib):
    """dist_local_merge="native" (csrc k-way merge via pure_callback)
    is bit-identical to the re-sort path. Non-default (measured ~10%
    slower in context under shard_map despite a 4-9x standalone win),
    but kept as a supported option."""
    import importlib

    ds_mod = importlib.import_module("sortx.parallel.dist_sort")

    mesh = _mesh()
    n = 20_000
    keys = rng.randint(0, 256, size=n - 13).astype(np.uint32)
    vals = np.arange(n - 13, dtype=np.uint32)
    out = {}
    for mode in ("sort", "native"):
        cfg = sortx.Config(dist_local_merge=mode)
        out[mode] = tuple(np.asarray(x) for x in dist_sort_kv(
            jnp.asarray(keys), jnp.asarray(vals), mesh=mesh, config=cfg))
        assert ds_mod.last_local_merge == mode
    for a, b in zip(out["sort"], out["native"]):
        np.testing.assert_array_equal(a, b)


@needs_multi
def test_emulated_ragged_all_to_all_matches_numpy_model(rng):
    """Pin _emulate_ragged_all_to_all to lax.ragged_all_to_all's
    documented contract with an independent numpy model: random count
    matrices (zero-size segments included), sender-side output offsets,
    untouched slots keep the output buffer's prior values."""
    from jax.sharding import PartitionSpec as P

    from sortx.parallel.dist_sort import _emulate_ragged_all_to_all
    from sortx.parallel.mesh import AXIS

    mesh = _mesh()
    d = mesh.shape[AXIS]
    m, out_len, base = 32, 64, 777
    # random sender->receiver counts with row sums <= m
    c = rng.randint(0, 2, size=(d, d)) * rng.randint(0, m // d + 1,
                                                     size=(d, d))
    assert c.sum(axis=1).max() <= m
    in_off = (np.cumsum(c, axis=1) - c).astype(np.int32)      # [d, d]
    out_off = (np.cumsum(c, axis=0) - c).astype(np.int32)     # [d, d]
    ops = rng.randint(0, 2**32, size=(d, m), dtype=np.uint32)

    def body(op):
        me = jax.lax.axis_index(AXIS)
        cj = jnp.asarray(c, jnp.int32)
        send = cj[me, :]
        ioff = jnp.asarray(in_off)[me, :]
        ooff = jnp.asarray(out_off)[me, :]
        recv = cj[:, me]
        out = jnp.full((out_len,), base, jnp.uint32)
        return _emulate_ragged_all_to_all(op, out, ioff, send, ooff,
                                          recv, axis_name=AXIS)

    got = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(AXIS),), out_specs=P(AXIS),
        check_vma=False))(jnp.asarray(ops.reshape(-1)))
    got = np.asarray(got).reshape(d, out_len)
    exp = np.full((d, out_len), base, np.uint32)
    for i in range(d):          # sender
        for j in range(d):      # receiver
            s = c[i, j]
            exp[j, out_off[i, j]:out_off[i, j] + s] = (
                ops[i, in_off[i, j]:in_off[i, j] + s])
    np.testing.assert_array_equal(got, exp)


@needs_multi
@pytest.mark.parametrize("case", ["uniform", "kv", "equal", "ragged"])
def test_ragged_exchange_contract_drives_execution(rng, case):
    """Round-4 VERDICT item 3: the ragged-exchange ARGUMENT CONTRACT
    (_shard_sort's offsets/sizes from _plan_from_counts /
    _segment_layout) actually drives execution — swap the collective
    for the executable spec and run the FULL PSRS pipeline with
    use_ragged=True on the CPU mesh, asserting bit-equality with both
    the oracle and the production dense path."""
    import importlib
    ds_mod = importlib.import_module("sortx.parallel.dist_sort")

    mesh = _mesh()
    n = 40_013 if case == "ragged" else 40_000
    if case == "equal":
        keys = np.full(n, 0xABCD1234, np.uint32)
    else:
        keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    kv = case == "kv"
    # drop any executable traced with the real collective (same cache key)
    ds_mod._jitted_shard_sort.cache_clear()
    ds_mod._ragged_impl = ds_mod._emulate_ragged_all_to_all
    try:
        if kv:
            ks, vs = dist_sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                                  mesh=mesh, use_ragged=True)
            got = (np.asarray(ks), np.asarray(vs))
        else:
            got = (np.asarray(dist_sort(jnp.asarray(keys), mesh=mesh,
                                        use_ragged=True)),)
        assert ds_mod.last_exchange == "ragged"
    finally:
        ds_mod._ragged_impl = None
        ds_mod._jitted_shard_sort.cache_clear()
    exp = (reference.radix_sort_kv(keys, vals) if kv
           else (reference.radix_sort(keys),))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)
    if kv:
        dk, dv = dist_sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                              mesh=mesh, use_ragged=False)
        dense = (np.asarray(dk), np.asarray(dv))
    else:
        dense = (np.asarray(dist_sort(jnp.asarray(keys), mesh=mesh,
                                      use_ragged=False)),)
    for g, e in zip(got, dense):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("entry", ["dist_sort", "dist_sort_kv",
                                   "dist_sort_padded",
                                   "dist_sort_kv_padded"])
def test_use_ragged_refused_without_collective(entry):
    """With no ragged collective installed, use_ragged=True is a typed
    error on every entry point, never a run of a collective that is
    unimplemented (XLA:CPU) or gave wrong answers (H100)."""
    import importlib
    ds_mod = importlib.import_module("sortx.parallel.dist_sort")

    assert ds_mod._ragged_impl is None
    keys = jnp.arange(64, dtype=jnp.uint32)[::-1]
    args = (keys, keys) if "kv" in entry else (keys,)
    with pytest.raises(ValueError, match="use_ragged=True"):
        getattr(ds_mod, entry)(*args, mesh=make_sort_mesh(1),
                               use_ragged=True)
    # The default exchange still answers on the same mesh.
    out = getattr(ds_mod, entry)(*args, mesh=make_sort_mesh(1))
    first = out if entry == "dist_sort" else out[0]
    np.testing.assert_array_equal(np.asarray(first), np.arange(64))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["uniform", "equal"])
def test_dist_sort_dense_exchange_on_gpu(multi_device, rng, case):
    """The default dense exchange on a multi-GPU mesh, uniform and
    all-equal keys, against numpy (the collectives run on NCCL)."""
    mesh = make_sort_mesh()
    n = len(multi_device) * (1 << 20) + 7
    keys = (rng.randint(0, 2**32, size=n, dtype=np.uint32)
            if case == "uniform" else np.full(n, 3, np.uint32))
    vals = np.arange(n, dtype=np.uint32)
    ks, vs = dist_sort_kv(jnp.asarray(keys), jnp.asarray(vals), mesh=mesh)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(np.asarray(ks), keys[order])
    assert np.array_equal(np.asarray(vs), order.astype(np.uint32))
