"""Scalar math helpers.

Analog of the reference's host math helpers
(``Tahoe/Math/Math.h:230-256,324-330``: ``nextPowerOf2``, ``NEXTMULTIPLEOF``,
``min2/max2/clamp``). The vector PODs (uint2/float4/...) have no analog —
jnp arrays subsume them.
"""

from __future__ import annotations

__all__ = ["cdiv", "next_pow2", "next_multiple_of", "clamp", "is_pow2"]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (Tahoe/Math/Math.h:324-330)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def next_multiple_of(x: int, m: int) -> int:
    """Round x up to a multiple of m (NEXTMULTIPLEOF, Tahoe/Math/Math.h)."""
    return cdiv(x, m) * m


def clamp(x, lo, hi):
    return max(lo, min(hi, x))


def is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0
