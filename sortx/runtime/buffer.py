"""Typed device buffers with accounting.

Analog of ``adl::Buffer<T>`` / ``HostBuffer<T>`` / ``BufferUtils``
(``Adl/Adl.h:161-274``, ``Adl/Adl.inl:201-557``): allocate, read/write
(host<->device and device<->device), fill/clear, grow, and map semantics —
implemented over ``jax.Array`` + ``device_put``. Async read/write returns the
in-flight ``jax.Array`` itself (XLA arrays are futures), which subsumes the
reference's ``SyncObject`` (``Adl/AdlKernel.h:45-54``): ``wait()`` is
``block_until_ready``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .device import SortxDevice

__all__ = ["Buffer", "SyncObject"]


class SyncObject:
    """Completion handle (Adl/AdlKernel.h:45-54 analog).

    Wraps one or more in-flight jax.Arrays; ``is_complete`` polls without
    blocking (cl_event::isComplete analog, Adl/CL/AdlCL.inl:616-634).
    """

    def __init__(self, *arrays):
        self._arrays = arrays

    def wait(self) -> None:
        for a in self._arrays:
            a.block_until_ready()

    @property
    def is_complete(self) -> bool:
        return all(a.is_ready() for a in self._arrays)


class Buffer:
    """A typed, device-resident 1D buffer.

    Mirrors the reference Buffer<T> capability set (Adl/Adl.h:161-222):
      - allocate(n) / set_size(n)  (setSize does NOT preserve contents,
        matching Adl/Adl.inl:331-356)
      - write(host_array) / read() -> numpy  (blocking or async)
      - write_buffer(other) (device-to-device copy, AdlCL.inl:442-483)
      - fill(value) / clear()  (DeviceCL::clear/fill via memclear kernel,
        AdlCL.inl:513-541; here one fused XLA fill)
      - get_host_ptr()/return_host_ptr() map semantics -> read()/write()
    """

    def __init__(self, device: SortxDevice, dtype, n: int = 0):
        self.device = device
        self.dtype = jnp.dtype(dtype)
        self._arr: Optional[jax.Array] = None
        self._nbytes = 0
        if n:
            self.set_size(n)

    # -- lifecycle ----------------------------------------------------
    @property
    def size(self) -> int:
        return 0 if self._arr is None else self._arr.shape[0]

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def set_size(self, n: int) -> None:
        """(Re)allocate to n elements; contents are NOT preserved."""
        if n == self.size:
            return
        self._release()
        if n > 0:
            self._arr = jax.device_put(
                jnp.zeros((n,), dtype=self.dtype), self.device.jax_device)
            self._nbytes = n * self.dtype.itemsize
            self.device._on_alloc(self._nbytes)

    def _release(self) -> None:
        if self._arr is not None:
            self.device._on_free(self._nbytes)
            self._arr = None
            self._nbytes = 0

    def destroy(self) -> None:
        self._release()

    # -- data movement ------------------------------------------------
    @property
    def array(self) -> jax.Array:
        if self._arr is None:
            raise RuntimeError("buffer not allocated")
        return self._arr

    @array.setter
    def array(self, value: jax.Array) -> None:
        """Adopt a device array produced by a kernel (zero-copy rebind)."""
        if value.shape != (self.size,) or value.dtype != self.dtype:
            raise ValueError(
                f"shape/dtype mismatch: {value.shape}/{value.dtype} vs "
                f"({self.size},)/{self.dtype}")
        self._arr = value

    def write(self, host, n: Optional[int] = None, *, blocking: bool = True
              ) -> Optional[SyncObject]:
        host = np.asarray(host, dtype=self.dtype)
        n = len(host) if n is None else n
        if n > self.size:
            raise ValueError(f"write of {n} exceeds buffer size {self.size}")
        if n == self.size:
            arr = jax.device_put(host[:n], self.device.jax_device)
        else:
            arr = self.array.at[:n].set(jax.device_put(
                host[:n], self.device.jax_device))
        self._arr = arr
        if blocking:
            arr.block_until_ready()
            return None
        return SyncObject(arr)

    def write_buffer(self, src: "Buffer", n: Optional[int] = None) -> None:
        """Device-to-device copy (Buffer::write(Buffer&), Adl/Adl.inl)."""
        n = src.size if n is None else n
        if n == self.size:
            self._arr = jnp.asarray(src.array[:n], dtype=self.dtype)
        else:
            self._arr = self.array.at[:n].set(src.array[:n])

    def read(self, n: Optional[int] = None, *, blocking: bool = True):
        n = self.size if n is None else n
        out = self.array[:n]
        if blocking:
            return np.asarray(out)
        return out  # jax.Array future; np.asarray(...) when needed

    def fill(self, value) -> None:
        self._arr = jnp.full((self.size,), value, dtype=self.dtype)
        self._arr = jax.device_put(self._arr, self.device.jax_device)

    def clear(self) -> None:
        self.fill(0)

    # -- map semantics (BufferUtils, Adl/Adl.inl:370-535) -------------
    def get_host_ptr(self) -> np.ndarray:
        """Map for CPU access: returns a mutable host mirror.

        NOT zero-copy: the reference's ``getHostPtr`` maps the device
        allocation in place (``clEnqueueMapBuffer``,
        ``Adl/CL/AdlCL.inl:544-555``); ``jax.Array`` is immutable and
        device memory is not host-addressable, so this is a
        device->host COPY and ``return_host_ptr`` is the host->device
        copy back. The map/modify/unmap call pattern round-trips
        identically; the cost model differs (2x PCIe traffic vs 0)."""
        return np.asarray(self.array).copy()

    def return_host_ptr(self, host: np.ndarray) -> None:
        """Unmap: push the (possibly modified) host mirror back."""
        self.write(host)

    def __len__(self):
        return self.size

    def __repr__(self):
        return f"Buffer({self.dtype}, n={self.size}, dev={self.device.name})"
