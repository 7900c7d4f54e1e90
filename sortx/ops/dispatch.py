"""The one place that chooses between implementations.

Every sort in sortx is XLA's ``lax.sort``; what remains to choose is
decided here, from what the caller's input shows (the backend, n) and
from ``Config``:

- ``"scan"``: ``"triton"``, the three-pass Pallas kernel of
  ``ops/scan.py``, on a GPU for n >= ``TRITON_SCAN_MIN_N``, where it was
  measured faster than ``jnp.cumsum`` end to end; ``"xla"``
  (``jnp.cumsum``) everywhere else.
- ``"dist_merge"``: the distributed sort's merge of the received runs,
  ``"sort"``, ``"rank"`` or ``"native"`` (the last needs the CPU
  backend and the built csrc library, else it falls back to ``"sort"``).
"""

from __future__ import annotations

import jax

from ..config import Config

__all__ = ["resolve", "TRITON_SCAN_MIN_N"]

# Smallest n from which the Triton scan beat jnp.cumsum end to end in
# every run. On an NVIDIA H100 80GB HBM3 (400 W limit), median wall time
# of 100 calls to block_until_ready, triton vs cumsum: 2^20 173 vs 159
# us, 2^22 202 vs 190, 2^23 210 vs 250 (another run, 30 calls: 300 vs
# 291), 2^24 253 vs 327, 2^27 793 vs 1176. Below 2^24 host dispatch
# hides the kernel's lower device time (7.4 vs 14.3 us at 2^20).
TRITON_SCAN_MIN_N = 1 << 24


def resolve(op: str, cfg: Config, n: int = 0) -> str:
    """Implementation that ``op`` runs for ``n`` elements under ``cfg``."""
    backend = jax.default_backend()
    if op == "scan":
        if backend == "gpu" and n >= TRITON_SCAN_MIN_N:
            return "triton"
        return "xla"
    if op == "dist_merge":
        mode = cfg.dist_local_merge
        if mode == "auto":
            return "sort"
        if mode == "native":
            from ..runtime import native

            if backend != "cpu" or not native.available():
                return "sort"
        return mode
    raise ValueError(f"no implementation choice for op {op!r}")
