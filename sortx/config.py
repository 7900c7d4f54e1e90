"""Runtime and algorithm configuration.

Analog of the reference's three config tiers (SURVEY §5): compile-time
backend toggles (``Adl/AdlConfig.h:5-13``), algorithm tuning enums
(``Tahoe/ParallelPrimitives/Pprims.h:22-33``), and the runtime
``DeviceUtils::Config`` POD (``Adl/Adl.h:74-96``) — collapsed into one
runtime dataclass, because JAX recompiles per-config instead of rebuilding.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["Config", "default_config", "set_default_config"]

_GONE = "the Pallas bitonic/sample-sort engine it tuned was removed"

# Knobs and environment variables that no longer exist, with the reason
# a caller sees in the ValueError.
_REMOVED_KNOBS = {
    "engine_log_block": _GONE,
    "engine_tile_elems": _GONE,
    "engine_buckets": _GONE,
    "engine_min_n": _GONE,
    "engine_headroom": _GONE,
    "engine_chunk_elems": _GONE,
    "engine_dma_slots": _GONE,
    "engine_phase_sort": _GONE,
    "interpret": "no Pallas kernel of the public API runs in interpret mode",
    "scan_tile_elems": "the scan kernel it tuned was replaced",
    "scan_use_mxu": "the scan kernel it tuned was replaced",
    "dist_exchange": "the 'ring' schedule was removed; 'a2a' always runs",
    "engine": ("the Pallas engines it chose were removed; sortx.ops.dispatch "
               "picks each implementation from the backend and the input"),
    "bits_per_pass": "no sort pass of sortx reads it; XLA's sort sets its own",
}
_REMOVED_VALUES = {
    ("dist_local_merge", "tree"): "the bitonic merge tree was removed",
}
_REMOVED_ENV = ("SORTX_ENGINE", "SORTX_INTERPRET")


@dataclasses.dataclass(frozen=True)
class Config:
    """Tuning knobs for the sort/scan primitives (analog of the
    reference tuning enums, ``Pprims.h:22-33``)."""

    # Elements per tile of the per-tile digit histogram.
    sort_tile_elems: int = 1 << 14

    # Distributed dense-exchange cells are padded to 2*ceil(m/D) (the
    # diagonal cell never crosses the wire), with an in-graph fallback to
    # full-m cells when the gathered count matrix overflows the cap —
    # O(m) wire traffic per shard instead of O(D*m). False forces the
    # always-correct full-m padding unconditionally.
    dist_dense_bounded: bool = True

    # Distributed local merge of the d received sorted runs: "sort" =
    # full re-sort of the receive buffer; "rank" = searchsorted
    # co-ranking + scatter; "native" = csrc parallel k-way merge via
    # pure_callback (CPU backend only). "auto" = "sort".
    dist_local_merge: str = "auto"

    # Per-launch profiling (analog of Device::toggleProfiling ->
    # ProfileCL.*.csv, AdlKernelUtilsCL.inl:664-677).
    profile: bool = False
    profile_csv: Optional[str] = None

    def __post_init__(self):
        for (field, value), why in _REMOVED_VALUES.items():
            if getattr(self, field) == value:
                raise ValueError(f"Config({field}={value!r}) was removed: "
                                 f"{why}")
        if self.sort_tile_elems % 1024 != 0:
            raise ValueError("sort_tile_elems must be a multiple of 1024")
        if self.dist_local_merge not in ("auto", "native", "rank", "sort"):
            raise ValueError("dist_local_merge must be auto|native|rank|sort")


_dataclass_init = Config.__init__


def _init(self, *args, **kwargs):
    for name in kwargs.keys() & _REMOVED_KNOBS.keys():
        raise ValueError(f"Config({name}=...) was removed: "
                         f"{_REMOVED_KNOBS[name]}")
    _dataclass_init(self, *args, **kwargs)


Config.__init__ = _init


def check_removed_env(environ=os.environ) -> None:
    """Refuse environment variables that used to select the removed
    engine, so that setting one is never silently ignored."""
    for name in _REMOVED_ENV:
        if name in environ:
            raise ValueError(f"environment variable {name} was removed: "
                             f"{_GONE}")


check_removed_env()
_default = Config()


def default_config() -> Config:
    return _default


def set_default_config(cfg: Config) -> None:
    global _default
    _default = cfg
