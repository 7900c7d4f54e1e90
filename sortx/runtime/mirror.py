"""Host/device mirrored array with dirty-state coherence.

Analog of ``uArray<T>``
(``Tahoe/ParallelPrimitives/uArray.h:13-228``): a numpy-backed host array
mirrored by a lazily-allocated device array, with a coherence state machine
(CLEAN / CPU_DIRTY / GPU_DIRTY / UNINITIALIZED) that syncs on access —
``prepareAccessCpu`` / ``prepareAccessGpu`` semantics preserved exactly.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["MirrorState", "MirroredArray"]


class MirrorState(Enum):
    """uArray.h:20-26 state machine."""

    UNINITIALIZED = 0
    CLEAN = 1        # host and device agree
    CPU_DIRTY = 2    # host modified; device stale
    GPU_DIRTY = 3    # device modified; host stale


class MirroredArray:
    """A host array with a coherent, lazily-created device mirror."""

    def __init__(self, dtype, n: int = 0, device=None):
        self.dtype = np.dtype(dtype)
        self._host = np.zeros(n, dtype=self.dtype)
        self._dev: Optional[jax.Array] = None
        self._device = device or jax.devices()[0]
        self.state = MirrorState.UNINITIALIZED if n == 0 else MirrorState.CPU_DIRTY

    @property
    def size(self) -> int:
        return self._host.shape[0]

    def set_size(self, n: int) -> None:
        """Grow/shrink; preserves host contents up to min(n, old), unlike
        adl::Buffer::setSize but like Tahoe::Array::setSize (Array.h:147)."""
        if n == self.size:
            return
        self.prepare_access_cpu()
        old = self._host
        self._host = np.zeros(n, dtype=self.dtype)
        self._host[: min(n, old.shape[0])] = old[: min(n, old.shape[0])]
        self._dev = None
        self.state = MirrorState.CPU_DIRTY

    # -- coherence protocol (uArray.h:157-212) ------------------------
    def prepare_access_cpu(self) -> np.ndarray:
        """Make the host copy current and mark it writable (CPU_DIRTY)."""
        if self.state == MirrorState.GPU_DIRTY:
            self._host = np.asarray(self._dev)
        self.state = MirrorState.CPU_DIRTY
        return self._host

    def prepare_access_gpu(self) -> jax.Array:
        """Make the device copy current and mark it writable (GPU_DIRTY)."""
        if self._dev is None or self.state == MirrorState.CPU_DIRTY:
            self._dev = jax.device_put(self._host, self._device)
        self.state = MirrorState.GPU_DIRTY
        return self._dev

    # -- reads without claiming write access --------------------------
    def host_view(self) -> np.ndarray:
        if self.state == MirrorState.GPU_DIRTY:
            self._host = np.asarray(self._dev)
            self.state = MirrorState.CLEAN
        return self._host

    def device_view(self) -> jax.Array:
        """getGpuBuffer analog (uArray.h:196-212)."""
        if self._dev is None or self.state == MirrorState.CPU_DIRTY:
            self._dev = jax.device_put(self._host, self._device)
            if self.state == MirrorState.CPU_DIRTY:
                self.state = MirrorState.CLEAN
        return self._dev

    def set_device_result(self, arr: jax.Array) -> None:
        """Adopt a kernel output as the new device contents (GPU_DIRTY)."""
        if arr.shape != (self.size,) or arr.dtype != jnp.dtype(self.dtype):
            raise ValueError("shape/dtype mismatch adopting device result")
        self._dev = arr
        self.state = MirrorState.GPU_DIRTY

    def __getitem__(self, idx):
        return self.host_view()[idx]

    def __setitem__(self, idx, value):
        self.prepare_access_cpu()[idx] = value
