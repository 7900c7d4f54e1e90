"""Exclusive prefix scan — the keystone primitive.

Replacement for the reference's 3-kernel scan pipeline (``Pprims::scan``,
``Tahoe/ParallelPrimitives/Pprims.cpp:122-179``; kernels in
``Tahoe/ClKernels/PrefixScanKernels.cl``), whose single-work-group top
level caps n at 4096*256 = 2^20 elements (the known Demo.Scan failure,
``Pprims.cpp:134-138``). Here n is unbounded.

Two implementations, chosen by ``ops.dispatch.resolve("scan", ...)``:

  - ``"xla"``: ``jnp.cumsum`` in u32 (wraps identically for int32).
  - ``"triton"``: the reference's three-pass shape on Hopper — per-block
    totals (an XLA reduction), an exclusive scan of the few thousand
    totals (XLA), then one Pallas kernel through Triton that scans each
    block in registers (Triton's associative scan) and adds the block's
    offset. Blocks run in parallel and in no order, so nothing is carried
    between them. 12 bytes moved per element (read, read, write).

Semantics: exclusive prefix sum with 32-bit wraparound, identical to the
reference oracle (``UnitTest/main.cpp:193-199``); optional grand total
(``Pprims.h:35`` ``sum`` argument).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import Config, default_config
from ..runtime.launcher import profiled
from ..utils.math import cdiv
from .dispatch import resolve

__all__ = ["scan"]

# Elements per Triton block, and warps per block. Blocks are powers of
# two; at the smallest n the kernel runs for (dispatch.TRITON_SCAN_MIN_N
# = 2^24) this leaves 8192 blocks, about 62 for each of the H100's 132
# SMs. Swept at 2^27 on an H100 80GB HBM3 (400 W limit) over blocks of
# 2^10..2^14 and 4, 8 or 16 warps: every setting fell within 0.76-0.92
# ms a call, with 2^11 and 8 warps fastest.
_BLOCK = 1 << 11
_NUM_WARPS = 8


def _block_scan_kernel(x_ref, off_ref, o_ref, *, n: int, block: int,
                       inclusive: bool):
    if n % block:
        # Ragged tail: mask the last block's loads and stores, so the
        # wrapper needs no padded copy of the input or output.
        idx = pl.program_id(0) * block + jax.lax.iota(jnp.int32, block)
        mask = idx < n
        x = pltriton.load(x_ref, mask=mask, other=0)
    else:
        x = x_ref[...]
    incl = jax.lax.cumsum(x, axis=0)
    out = (incl if inclusive else incl - x) + off_ref[...]
    if n % block:
        pltriton.store(o_ref, out, mask=mask)
    else:
        o_ref[...] = out


@functools.partial(jax.jit, static_argnames=("inclusive", "block",
                                              "interpret"))
def _scan_triton(xi, *, inclusive: bool, block: int = _BLOCK,
                 interpret: bool = False):
    """Three-pass scan of int32 ``xi``; returns (scanned [n], total)."""
    n = xi.shape[0]
    nb = cdiv(n, block)
    full = n // block
    totals = jnp.sum(xi[:full * block].reshape(full, block), axis=1,
                     dtype=jnp.int32)
    if full < nb:
        totals = jnp.concatenate(
            [totals, jnp.sum(xi[full * block:], dtype=jnp.int32)[None]])
    incl_t = jnp.cumsum(totals)
    offsets = incl_t - totals
    out = pl.pallas_call(
        functools.partial(_block_scan_kernel, n=n, block=block,
                          inclusive=inclusive),
        grid=(nb,),
        in_specs=[pl.BlockSpec((block,), lambda i: (i,)),
                  pl.BlockSpec((1,), lambda i: (i,))],
        out_specs=pl.BlockSpec((block,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.int32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="sortx_block_scan",
    )(xi, offsets)
    return out, incl_t[-1]


def _scan_cumsum(x, *, inclusive: bool):
    """``jnp.cumsum`` scan of a non-empty 32-bit ``x``; returns
    (scanned, total). Runs in u32, which wraps identically for int32."""
    xi = x.astype(jnp.uint32) if x.dtype == jnp.int32 else x
    incl = jnp.cumsum(xi)
    out = (incl if inclusive else incl - xi).astype(x.dtype)
    return out, incl[-1].astype(x.dtype)


@profiled("scan")
def scan(x, *, with_total: bool = False, inclusive: bool = False,
         config: Config | None = None):
    """Prefix sum of a 1D 32-bit array (exclusive by default).

    Args:
      x: 1D int32/uint32 array (any length; no 2^20 cap, unlike the
        reference's ``Pprims.cpp:134-138``).
      with_total: also return the grand total (``Pprims::scan`` sumOut).
      inclusive: inclusive instead of exclusive scan (beyond-reference).
      config: engine configuration; defaults to the global config.

    Returns:
      Scanned array of x.dtype, and the total if requested. Arithmetic
      wraps mod 2^32, bit-identical to the reference's u32 semantics.
    """
    cfg = config or default_config()
    if x.ndim != 1:
        raise ValueError("scan expects a 1D array")
    n = x.shape[0]
    dtype = x.dtype
    if dtype not in (jnp.int32, jnp.uint32):
        raise TypeError(f"scan supports 32-bit integer arrays, got {dtype}")
    if n == 0:
        total = jnp.zeros((), dtype)
        return (x, total) if with_total else x

    if resolve("scan", cfg, n) == "triton":
        xi = x.view(jnp.int32) if dtype == jnp.uint32 else x
        out, total = _scan_triton(xi, inclusive=inclusive)
        out, total = out.view(dtype), total.view(dtype)
        return (out, total) if with_total else out

    out, total = _scan_cumsum(x, inclusive=inclusive)
    return (out, total) if with_total else out
