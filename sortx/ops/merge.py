"""merge / merge_kv — combine two pre-sorted arrays without a re-sort.

Beyond-reference primitive (the reference re-sorts from scratch; its
only primitives are scan/sort, ``Tahoe/ParallelPrimitives/Pprims.h:35-41``).
Each element's output position is its own index plus its rank in the
other input (two ``searchsorted`` calls), then one scatter per stream.

Tie semantics match ``std::merge``/``numpy``: on equal keys, elements of
``a`` precede elements of ``b``, and each input's internal order is
preserved (for keys-only output the property is vacuous).

Precondition: each input is already sorted in the requested order
(ascending, or descending when ``descending=True``). Like
``std::merge``, this is NOT validated — unsorted inputs produce
unspecified output.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import Config
from ..runtime.launcher import profiled

__all__ = ["merge", "merge_kv"]

def _check_pair(a, b):
    from .sort import _check_keys

    _check_keys(a)
    _check_keys(b)
    if a.dtype != b.dtype:
        raise TypeError(f"merge inputs must share a dtype, got "
                        f"{a.dtype} vs {b.dtype}")


def _merge_xla(ka, kb, payloads_a=(), payloads_b=()):
    """Stable positional merge: rank arithmetic + scatter.

    Element i of a lands at i + |{b < a[i]}| (side='left'); element j of
    b lands at j + |{a <= b[j]}| (side='right') — disjoint and complete,
    and ties place a's elements first.
    """
    na, nb = ka.shape[0], kb.shape[0]
    pos_a = (jnp.arange(na, dtype=jnp.int32)
             + jnp.searchsorted(kb, ka, side="left").astype(jnp.int32))
    pos_b = (jnp.arange(nb, dtype=jnp.int32)
             + jnp.searchsorted(ka, kb, side="right").astype(jnp.int32))
    outs = []
    for xa, xb in ((ka, kb), *zip(payloads_a, payloads_b)):
        o = jnp.zeros((na + nb,), xa.dtype)
        outs.append(o.at[pos_a].set(xa).at[pos_b].set(xb))
    return outs


@profiled("merge")
def merge(a, b, *, descending: bool = False, config: Config | None = None):
    """Merge two sorted key arrays into one sorted array.

    Inputs must each already be sorted (ascending, or descending when
    ``descending=True``); dtypes u32/i32/f32 as in ``sort``.
    """
    from .sort import _order_mask, _to_radix_u32

    del config
    _check_pair(a, b)
    if a.shape[0] == 0:
        return b
    if b.shape[0] == 0:
        return a
    ka, undo = _to_radix_u32(a)
    kb, _ = _to_radix_u32(b)
    if descending:
        ka = ka ^ _order_mask(32)
        kb = kb ^ _order_mask(32)
    (out,) = _merge_xla(ka, kb)
    if descending:
        out = out ^ _order_mask(32)
    return undo(out)


@profiled("merge_kv")
def merge_kv(keys_a, values_a, keys_b, values_b, *,
             descending: bool = False, config: Config | None = None):
    """Merge two sorted key-value arrays; returns ``(keys, values)``.

    Stable in the ``std::merge`` sense: equal keys take ``a``'s elements
    before ``b``'s, each input's internal order preserved. Values may be
    any 32-bit dtype (shared between the two inputs).
    """
    from .sort import _order_mask, _to_radix_u32

    del config
    _check_pair(keys_a, keys_b)
    if values_a.shape != keys_a.shape or values_b.shape != keys_b.shape:
        raise ValueError("keys and values must have the same shape")
    if values_a.dtype != values_b.dtype:
        raise TypeError("merge_kv value dtypes must match")
    if keys_a.shape[0] == 0:
        return keys_b, values_b
    if keys_b.shape[0] == 0:
        return keys_a, values_a
    ka, undo = _to_radix_u32(keys_a)
    kb, _ = _to_radix_u32(keys_b)
    if descending:
        ka = ka ^ _order_mask(32)
        kb = kb ^ _order_mask(32)
    out_k, out_v = _merge_xla(ka, kb, (values_a,), (values_b,))
    if descending:
        out_k = out_k ^ _order_mask(32)
    return undo(out_k), out_v
