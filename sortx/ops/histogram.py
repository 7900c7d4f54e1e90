"""Public digit-histogram primitive.

Exposes the StreamCountKernel analog (``RadixSort32Kernels.cl:176-236``)
as a standalone op: counts of ``(x >> shift) & (2^bits - 1)`` over a u32
array — per tile or global — as a one-hot reduction in plain XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Config, default_config
from ..runtime.launcher import profiled
from ..utils.math import cdiv

__all__ = ["histogram"]


@profiled("histogram")
def histogram(x, bits: int = 8, shift: int = 0, *,
              per_tile: bool = False, config: Config | None = None):
    """Counts of the ``bits``-wide digit at ``shift`` in u32 keys.

    Args:
      x: 1D uint32/int32 array.
      bits: digit width, 1..8 (radix = 2^bits buckets).
      shift: bit offset of the digit.
      per_tile: if True, return (num_tiles, radix) per-tile counts
        (the sort engine's bucket-major table); else the global radix-
        sized histogram.

    Returns:
      int32 counts; global shape (radix,), per-tile (num_tiles, radix).
    """
    cfg = config or default_config()
    if x.ndim != 1:
        raise ValueError("histogram expects a 1D array")
    if x.dtype not in (jnp.uint32, jnp.int32):
        raise TypeError(f"histogram expects 32-bit integers, got {x.dtype}")
    if not (1 <= bits <= 8):
        raise ValueError("bits must be in 1..8")
    if not (0 <= shift <= 31):
        raise ValueError("shift must be in 0..31")
    radix = 1 << bits
    n = x.shape[0]
    if n == 0:
        shape = (1, radix) if per_tile else (radix,)
        return jnp.zeros(shape, jnp.int32)

    xi = x.view(jnp.uint32) if x.dtype == jnp.int32 else x

    d = ((xi >> jnp.uint32(shift)) & jnp.uint32(radix - 1)).astype(
        jnp.int32)
    if not per_tile:
        return jnp.sum(jax.nn.one_hot(d, radix, dtype=jnp.int32), axis=0)
    tile = cfg.sort_tile_elems
    padded = cdiv(n, tile) * tile
    d = jnp.pad(d, (0, padded - n), constant_values=radix)
    oh = jax.nn.one_hot(d.reshape(-1, tile), radix, dtype=jnp.int32)
    return jnp.sum(oh, axis=1)
