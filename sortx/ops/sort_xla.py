"""The sort: XLA's ``lax.sort`` on any JAX backend.

On the GPU, XLA hands a sort of one key with at most one payload to
CUB's radix sort; sorts with more operands run XLA's own comparison
sort. Built on ``lax.sort`` (stable), with the reference's exact
ordering contracts:

  - keys-only with partial ``sort_bits``: order by the low bits only,
    stable w.r.t. input order (``Pprims.cpp:253,357``);
  - key-value: stable on keys, values ride along (``RadixSort.cpp:10-56``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["sort_xla", "sort_kv_xla"]


def _masked(keys_u32, sort_bits: int):
    if sort_bits >= 32:
        return keys_u32
    mask = jnp.uint32((1 << sort_bits) - 1)
    return keys_u32 & mask


def _is_nondecreasing(k):
    return jnp.all(k[1:] >= k[:-1])


def _is_nonincreasing(k):
    return jnp.all(k[1:] <= k[:-1])


def sort_xla(keys, sort_bits: int = 32, *, adaptive: bool = True):
    """Stable sort of u32 keys by their low ``sort_bits`` bits.

    With ``adaptive`` (default), cheap pre-checks skip the sort when the
    input is already ordered — two reductions (~0.8% of a full sort) that
    make presorted inputs ~250x faster. Descending inputs just flip
    (keys-only: equal keys are indistinguishable, so the flip is a valid
    stable answer even with ties).
    """
    k = _masked(keys, sort_bits)
    if sort_bits >= 32:
        if adaptive and keys.shape[0] > 1:
            return jax.lax.cond(
                _is_nondecreasing(k),
                lambda v: v,
                lambda v: jax.lax.cond(
                    _is_nonincreasing(v),
                    lambda w: jnp.flip(w),
                    lambda w: jax.lax.sort(w, is_stable=True),
                    v),
                k)
        return jax.lax.sort(k, is_stable=True)
    # Order by masked key; carry the full key as payload so high bits of
    # equal-masked keys keep input order (is_stable) and original values.
    _, full = jax.lax.sort([k, keys], is_stable=True, num_keys=1)
    return full


def sort_kv_xla(keys, values, sort_bits: int = 32, *, adaptive: bool = True):
    """Stable key-value sort by the low ``sort_bits`` bits of keys.

    Presorted keys short-circuit to identity (which IS the stable answer:
    values already sit in original order within equal-key runs).
    """
    k = _masked(keys, sort_bits)
    if sort_bits >= 32:
        if adaptive and keys.shape[0] > 1:
            return jax.lax.cond(
                _is_nondecreasing(k),
                lambda kk, vv: (kk, vv),
                lambda kk, vv: tuple(jax.lax.sort([kk, vv], is_stable=True,
                                                  num_keys=1)),
                k, values)
        ks, vs = jax.lax.sort([k, values], is_stable=True, num_keys=1)
        return ks, vs
    _, full, vs = jax.lax.sort([k, keys, values], is_stable=True, num_keys=1)
    return full, vs


def sort_multi_xla(keys, payloads):
    """Stable sort of u32 keys carrying any number of 32-bit payloads."""
    outs = jax.lax.sort([keys, *payloads], is_stable=True, num_keys=1)
    return outs[0], tuple(outs[1:])
