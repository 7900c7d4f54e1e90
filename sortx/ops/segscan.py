"""Ragged segmented prefix scan: independent per-segment prefix sums.

Beyond-reference capability — the reference's ``Pprims::scan`` is one
flat exclusive sum (``Pprims.cpp:122-179``); this is its ragged
companion (CUB ``DeviceSegmentedScan`` shape), sharing the offsets
convention of ``sort_segments``.

Design: ONE pass of ``jax.lax.associative_scan`` with the classic
segmented-sum operator over (start-flag, value) pairs —
``(fa, va) ⊕ (fb, vb) = (fa | fb, vb + (fb ? 0 : va))`` — which is
associative, so XLA's log-step scan applies; cost is independent of the
segment count or length skew (one 1-element segment next to a 100M one
costs the same as balanced halves). Per-segment totals reuse the
flat ``sortx.scan`` (a global exclusive sum sampled at the
offsets), not a second segmented pass. Arithmetic wraps mod 2^32,
bit-identical to the flat scan's u32 semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Config, default_config
from ..runtime.launcher import profiled
from .scan import scan
from .segmented import _segment_ids

__all__ = ["scan_segments", "scan_by_key"]


@profiled("scan_segments")
def scan_segments(x, offsets, *, with_totals: bool = False,
                  inclusive: bool = False, config: Config | None = None):
    """Prefix-scan each ``x[offsets[i]:offsets[i+1]]`` independently.

    Args:
      x: 1D int32/uint32 array.
      offsets: CUB-style boundaries — S+1 nondecreasing ints with
        ``offsets[0] == 0`` and ``offsets[-1] == len(x)``; empty
        segments allowed (not validated under jit).
      with_totals: also return the per-segment sums, shape [S].
      inclusive: inclusive instead of exclusive scan.

    Returns:
      Array like x with every segment scanned (exclusive by default),
      and the [S] totals if requested. Mod-2^32 arithmetic.
    """
    cfg = config or default_config()
    if x.ndim != 1:
        raise ValueError("scan_segments expects a 1D array")
    dtype = x.dtype
    if dtype not in (jnp.int32, jnp.uint32):
        raise TypeError(f"scan_segments supports 32-bit integer arrays, "
                        f"got {dtype}")
    n = x.shape[0]
    n_seg = offsets.shape[0] - 1
    if offsets.ndim != 1 or n_seg < 1:
        raise ValueError("offsets must be 1D with at least 2 entries "
                         "(S+1 boundaries for S segments)")
    if n == 0:
        totals = jnp.zeros((n_seg,), dtype)
        return (x, totals) if with_totals else x

    xu = x.view(jnp.uint32) if dtype == jnp.int32 else x
    seg = _segment_ids(offsets, n)
    flags = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), seg[1:] != seg[:-1]])

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, vb + jnp.where(fb, jnp.uint32(0), va)

    _, incl = jax.lax.associative_scan(comb, (flags, xu))
    out = incl if inclusive else incl - xu
    out = out.view(jnp.int32) if dtype == jnp.int32 else out

    if not with_totals:
        return out
    # Totals = global exclusive scan (the flat sortx.scan) sampled at
    # the boundaries: sum(seg i) = g[offsets[i+1]] - g[offsets[i]].
    g, gt = scan(xu, with_total=True, config=cfg)
    g_ext = jnp.concatenate([g, gt[None]])
    totals = g_ext[offsets[1:]] - g_ext[offsets[:-1]]
    totals = totals.view(jnp.int32) if dtype == jnp.int32 else totals
    return out, totals


@profiled("scan_by_key")
def scan_by_key(keys, values, *, inclusive: bool = False,
                config: Config | None = None):
    """Prefix-scan ``values`` within runs of EQUAL consecutive keys
    (CUB ``DeviceScan::*SumByKey`` shape; beyond-reference).

    Segments are the maximal runs of equal adjacent keys — keys need
    not be sorted (a key that reappears later starts a NEW run, exactly
    CUB's semantics). Any equality-comparable key dtype. ``values``
    must be 32-bit integers (mod-2^32 arithmetic, bit-identical to the
    flat scan). For per-run totals and run boundaries, compose with
    ``run_length_encode`` + ``scan_segments``.
    """
    if keys.ndim != 1 or values.ndim != 1:
        raise ValueError("scan_by_key expects 1D arrays")
    if keys.shape != values.shape:
        raise ValueError("keys and values must have the same shape")
    dtype = values.dtype
    if dtype not in (jnp.int32, jnp.uint32):
        raise TypeError(f"scan_by_key supports 32-bit integer values, "
                        f"got {dtype}")
    n = values.shape[0]
    if n == 0:
        return values
    xu = values.view(jnp.uint32) if dtype == jnp.int32 else values
    flags = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), keys[1:] != keys[:-1]])

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, vb + jnp.where(fb, jnp.uint32(0), va)

    _, incl = jax.lax.associative_scan(comb, (flags, xu))
    out = incl if inclusive else incl - xu
    return out.view(jnp.int32) if dtype == jnp.int32 else out
