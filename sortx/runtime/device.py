"""Device discovery, selection and sync.

Analog of ``DeviceUtils`` / ``Device``
(``Adl/Adl.h:71-155``, ``Adl/Adl.inl:38-105``): enumerate devices, pick one
by type/index, query compute-unit count and memory, synchronize, and track
live buffer bytes with a leak check on teardown (``Adl/Adl.inl:102``).

JAX's runtime already owns contexts/queues, so this layer is thin —
its value is the uniform introspection + accounting surface the algorithm
layer and tests program against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax

from ..utils.log import Channel, log, log_error

__all__ = ["DeviceConfig", "SortxDevice", "allocate_device", "device_count"]


@dataclasses.dataclass
class DeviceConfig:
    """Analog of DeviceUtils::Config (Adl/Adl.h:74-96)."""

    platform: str = "auto"  # "gpu" | "cpu" | "auto"  (TYPE_CL/TYPE_HOST analog)
    device_idx: int = 0


class SortxDevice:
    """A selected accelerator with introspection and memory accounting."""

    def __init__(self, jax_device, platform: str):
        self.jax_device = jax_device
        self.platform = platform
        self.memory_usage = 0  # analog of Device::m_memoryUsage (AdlCL.inl:408)
        self._live_buffers = 0

    # ---- introspection (Adl/Adl.inl:38-71, AdlCL.inl:704-760) ----
    @property
    def n_cores(self) -> int:
        """Compute-unit count (getNCUs analog) where the device reports
        one, else 1."""
        return getattr(self.jax_device, "num_cores", None) or 1

    @property
    def name(self) -> str:
        return getattr(self.jax_device, "device_kind", str(self.jax_device))

    def memory_stats(self) -> dict:
        try:
            return self.jax_device.memory_stats() or {}
        except Exception:
            return {}

    @property
    def hbm_bytes(self) -> Optional[int]:
        return self.memory_stats().get("bytes_limit")

    # ---- sync (DeviceUtils::waitForCompletion, Adl/Adl.h:104-108) ----
    def wait_for_completion(self, *arrays) -> None:
        if arrays:
            for a in arrays:
                a.block_until_ready()
        else:
            # Barrier on all outstanding work for this device.
            jax.block_until_ready(
                jax.device_put(0, self.jax_device))

    # ---- accounting hooks used by runtime.buffer.Buffer ----
    def _on_alloc(self, nbytes: int) -> None:
        self.memory_usage += nbytes
        self._live_buffers += 1

    def _on_free(self, nbytes: int) -> None:
        self.memory_usage -= nbytes
        self._live_buffers -= 1

    def check_leaks(self) -> None:
        """Teardown leak assert (Adl/Adl.inl:102: ADLASSERT(used==0))."""
        if self.memory_usage != 0:
            log_error(
                f"device teardown with {self.memory_usage} bytes in "
                f"{self._live_buffers} live buffers")
            raise RuntimeError(
                f"sortx buffer leak: {self.memory_usage} bytes still allocated")

    def __repr__(self):
        return f"SortxDevice({self.name}, platform={self.platform})"


def device_count(platform: str = "auto") -> int:
    """Analog of DeviceUtils::getNDevices (Adl/Adl.h:113-116)."""
    if platform == "auto":
        return len(jax.devices())
    try:
        return len(jax.devices(platform))
    except RuntimeError:
        return 0


def allocate_device(config: DeviceConfig | None = None) -> SortxDevice:
    """Analog of DeviceUtils::allocate (Adl/Adl.inl:73-98).

    Picks the requested platform/device index; "auto" takes JAX's
    default backend (the reference prefers GPU vendors in priority
    order, AdlCL.inl:178-225).
    """
    config = config or DeviceConfig()
    platform = config.platform
    if platform == "auto":
        platform = jax.default_backend()
    devices = jax.devices(platform)
    if config.device_idx >= len(devices):
        raise IndexError(
            f"device_idx {config.device_idx} out of range "
            f"({len(devices)} {platform} devices)")
    dev = SortxDevice(devices[config.device_idx], platform)
    log(f"allocated {dev!r}", Channel.DEVICE)
    return dev
