"""Split-capable timer.

Analog of the reference's ``Stopwatch`` family (``Adl/AdlStopwatch.h:60-83``,
host impl ``Adl/Host/AdlStopwatchHost.inl:31-83``, CL impl = device-sync +
host clock ``Adl/CL/AdlStopwatchCL.inl:49-53``). The accurate variant is
the same recipe as the CL one: ``block_until_ready`` on the result, then a
host monotonic clock split.
"""

from __future__ import annotations

import time

import jax

__all__ = ["Stopwatch"]


class Stopwatch:
    """Monotonic timer with up to ``capacity`` splits (reference: 64)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._t = []

    def start(self, *sync) -> None:
        if sync:
            jax.block_until_ready(sync)
        self._t = [time.perf_counter()]

    def split(self, *sync) -> None:
        """Record a split; pass in-flight arrays to sync on device first."""
        if sync:
            jax.block_until_ready(sync)
        if len(self._t) < self.capacity:
            self._t.append(time.perf_counter())

    def stop(self, *sync) -> None:
        self.split(*sync)

    def get_ms(self, start_idx: int = 0, end_idx: int = -1) -> float:
        """Elapsed ms between two splits (Stopwatch::getMs analog)."""
        if len(self._t) < 2:
            return 0.0
        return (self._t[end_idx] - self._t[start_idx]) * 1e3

    @property
    def n_splits(self) -> int:
        return len(self._t)

    def split_times_ms(self) -> list[float]:
        return [(b - a) * 1e3 for a, b in zip(self._t, self._t[1:])]
