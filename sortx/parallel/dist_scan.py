"""Distributed exclusive/inclusive prefix scan over a device mesh.

New-scope companion of ``sortx.scan`` (the reference's ``Pprims::scan``
is single-device and caps at n < 2^20, ``Pprims.cpp:134-138``): the
classic two-level decomposition, but across chips — each shard runs the
single-chip ``sortx.scan`` on its local block, shard totals are
all-gathered (one [D] vector), and every shard
adds the sum of the lower-ranked totals. One collective of D scalars
total; everything else is local, so scaling is embarrassing by
construction.

Arithmetic wraps mod 2^32 and the result is bit-identical to the
single-chip ``sortx.scan`` for any mesh size or sharding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Config, default_config
from ..runtime.launcher import profiled
from ..ops.scan import scan as _scan
from ..utils.math import cdiv
from .dist_sort import _trim_tail_local
from .mesh import AXIS, make_sort_mesh

__all__ = ["dist_scan"]


def _shard_scan(xs, *, axis_name: str, inclusive: bool, cfg: Config):
    """Per-shard body (under shard_map): local scan + lower-shard carry."""
    local, lt = _scan(xs, with_total=True, inclusive=inclusive, config=cfg)
    totals = lax.all_gather(lt, axis_name)                    # [D]
    me = lax.axis_index(axis_name)
    d = totals.shape[0]
    carry = jnp.sum(jnp.where(jnp.arange(d) < me, totals,
                              jnp.zeros((), totals.dtype)))
    grand = jnp.sum(totals)
    return local + carry, grand


@functools.lru_cache(maxsize=128)
def _jitted_dist_scan(mesh: Mesh, inclusive: bool, cfg: Config):
    """Cached jitted shard_map (same rationale as dist_sort._jitted_*:
    a fresh jit per call re-traces the scan every time)."""
    body = functools.partial(_shard_scan, axis_name=AXIS,
                             inclusive=inclusive, cfg=cfg)
    mapped = jax.shard_map(body, mesh=mesh, in_specs=(P(AXIS),),
                           out_specs=(P(AXIS), P()), check_vma=False)
    return jax.jit(mapped,
                   out_shardings=(NamedSharding(mesh, P(AXIS)), None))


@profiled("dist_scan")
def dist_scan(x, *, with_total: bool = False, inclusive: bool = False,
              mesh: Mesh | None = None, config: Config | None = None):
    """Prefix sum of a 1D 32-bit array, sharded over a device mesh.

    Same contract as ``sortx.scan`` (exclusive by default, mod-2^32,
    optional grand total), computed shard-locally with one [D]-scalar
    all_gather. ``x`` may be sharded over the mesh or unsharded; the
    result is evenly sharded (ragged n is zero-padded internally — the
    pads cannot change any of the first n prefix values — and trimmed
    like ``dist_sort``).
    """
    cfg = config or default_config()
    if x.ndim != 1:
        raise ValueError("dist_scan expects a 1D array")
    dtype = x.dtype
    if dtype not in (jnp.int32, jnp.uint32):
        raise TypeError(f"dist_scan supports 32-bit integer arrays, "
                        f"got {dtype}")
    n = x.shape[0]
    if n == 0:
        total = jnp.zeros((), dtype)
        return (x, total) if with_total else x
    mesh = mesh or make_sort_mesh()
    d = mesh.shape[AXIS]
    m = cdiv(n, d)
    pad = d * m - n
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,), dtype)])

    out, grand = _jitted_dist_scan(mesh, inclusive, cfg)(x)

    if pad:
        if jax.process_count() == 1:
            out = _trim_tail_local(out, n)
        else:
            unshard = NamedSharding(mesh, P(None))
            out = jax.jit(lambda v: v[:n], out_shardings=unshard)(
                jax.sharding.reshard(out, unshard))
    if with_total:
        return out, grand
    return out
