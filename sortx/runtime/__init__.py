"""Runtime layer: device/buffer/launch/profiling (Adl analog)."""

from . import native
from . import profiler
from .buffer import Buffer, SyncObject
from .cache import cache_dir, enable_cache, warmup
from .device import DeviceConfig, SortxDevice, allocate_device, device_count
from .launcher import (Launcher, capture_next_op, profiling_enabled,
                       profiling_level, replay, replay_op,
                       toggle_profiling)
from .mirror import MirroredArray, MirrorState
from .stopwatch import Stopwatch

__all__ = [
    "Buffer",
    "SyncObject",
    "DeviceConfig",
    "SortxDevice",
    "allocate_device",
    "device_count",
    "Launcher",
    "replay",
    "replay_op",
    "capture_next_op",
    "toggle_profiling",
    "profiling_enabled",
    "profiling_level",
    "MirroredArray",
    "MirrorState",
    "Stopwatch",
    "cache_dir",
    "enable_cache",
    "warmup",
    "profiler",
    "native",
]
