"""Order statistics without a full sort: ``kth_value`` / ``median`` /
``top_k``.

Beyond-reference capability, but the natural payoff of the components
the reference pioneered: its count/scan machinery
(``StreamCountKernel`` + ``PrefixScan*``, ``RadixSort32Kernels.cl``)
is exactly a radix SELECTION engine if the scatter pass is dropped.

``kth_value``: 4 rounds of (8-bit histogram -> pick the bucket holding
rank k), narrowing one byte per round — O(n) work, 4 streaming passes,
no data movement at all.

``top_k``: two-phase tournament on the batched row-sort engine — rows
of L sort independently (one kernel-A pass), each contributes its top
k, and one small sort of the B*k candidates finishes. Any global top-k
element is top-k within its own row, so the candidate set is exact.
Tie semantics match ``jax.lax.top_k`` (equal keys -> lowest original
index), enforced by a (key desc, index asc) composite final sort.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, default_config
from ..runtime.launcher import profiled
from .extras import sort_u64
from .histogram import histogram
from .rows import sort_kv_rows, sort_rows
from .sort import _check_keys, _to_radix_u32, sort

__all__ = ["kth_value", "median", "top_k"]


@profiled("kth_value")
def kth_value(keys, k: int, *, config: Config | None = None):
    """The value of rank ``k`` (0-based) in the ascending sort of ``keys``.

    Equivalent to ``sortx.sort(keys)[k]`` — computed by 4 rounds of
    radix-256 histogram refinement instead of a sort (the reference's
    count+scan passes with the scatter dropped). ``k`` may be a Python
    int or a traced scalar. Returns a 0-d array of ``keys.dtype``.
    """
    cfg = config or default_config()
    _check_keys(keys)
    n = keys.shape[0]
    if n == 0:
        raise ValueError("kth_value of an empty array")
    if isinstance(k, (int, np.integer)) and not (0 <= int(k) < n):
        raise ValueError(f"k={k} out of range for n={n}")
    u, undo = _to_radix_u32(keys)
    rank = jnp.asarray(k, jnp.int32)
    prefix = jnp.uint32(0)
    n_match = jnp.int32(n)
    for shift in (24, 16, 8, 0):
        m = u >> jnp.uint32(shift)
        # Elements whose bytes above this round equal the chosen prefix
        # are the survivors; everything else is parked in bucket 0 and
        # subtracted (the histogram radix is a hard 256).
        match = (m >> jnp.uint32(8)) == prefix
        digit = jnp.where(match, m & jnp.uint32(0xFF), jnp.uint32(0))
        hist = histogram(digit, bits=8, shift=0, config=cfg)
        hist = hist.at[0].add(n_match - jnp.int32(n))
        cum = jnp.cumsum(hist)
        b = jnp.searchsorted(cum, rank, side="right").astype(jnp.int32)
        rank = rank - jnp.where(b > 0, cum[b - 1], 0)
        n_match = hist[b]
        prefix = (prefix << jnp.uint32(8)) | b.astype(jnp.uint32)
    return undo(prefix)


@profiled("median")
def median(keys, *, config: Config | None = None):
    """Lower median: ``sortx.sort(keys)[(n-1)//2]`` without the sort."""
    return kth_value(keys, (keys.shape[0] - 1) // 2, config=config)


def _top_k_shape(n: int, k: int):
    """Row geometry for the tournament, or None to sort directly."""
    L = 1024
    while L < 2 * k:
        L *= 2
    B = n // L
    # The tournament pays off once there are enough rows that the
    # candidate set (B*k) is much smaller than n.
    if B < 4 or B * k * 4 > n:
        return None
    return B, L


@profiled("top_k")
def top_k(keys, k: int, *, return_indices: bool = False,
          config: Config | None = None):
    """The ``k`` largest keys in descending order.

    Semantics match ``jax.lax.top_k`` (for integer keys bit-exactly;
    for floats, NaNs order by the monotone-transform convention of
    ``sortx.sort`` rather than being dropped): with
    ``return_indices=True`` returns ``(values, indices)`` where ties
    prefer the lowest original index.
    """
    cfg = config or default_config()
    _check_keys(keys)
    n = keys.shape[0]
    if not (0 < k <= n):
        raise ValueError(f"k={k} out of range for n={n}")
    u, _ = _to_radix_u32(keys)
    geom = _top_k_shape(n, k)

    if geom is None:
        cand_u, cand_idx = u, jnp.arange(n, dtype=jnp.uint32)
    else:
        B, L = geom
        BL = B * L
        # The tail beyond B*L rides as one extra candidate row slice.
        body = u[:BL].reshape(B, L)
        if return_indices:
            idx = jnp.arange(BL, dtype=jnp.uint32).reshape(B, L)
            rk, ri = sort_kv_rows(body, idx, descending=True, config=cfg)
            cand_u = jnp.concatenate([rk[:, :k].reshape(-1), u[BL:]])
            cand_idx = jnp.concatenate(
                [ri[:, :k].reshape(-1),
                 jnp.arange(BL, n, dtype=jnp.uint32)])
        else:
            rk = sort_rows(body, descending=True, config=cfg)
            cand_u = jnp.concatenate([rk[:, :k].reshape(-1), u[BL:]])
            cand_idx = None

    _, undo = _to_radix_u32(keys)
    if not return_indices:
        top = sort(cand_u, descending=True, config=cfg)[:k]
        return undo(top)
    # (key desc, index asc) composite — exact lax.top_k tie order.
    hi, lo = sort_u64(~cand_u, cand_idx, config=cfg)
    return undo(~hi[:k]), lo[:k].astype(jnp.int32)
