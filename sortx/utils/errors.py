"""Assertion / debug-check subsystem.

Analog of the reference's ``ADLASSERT`` machinery (``Tahoe/Math/Error.h:
24-39``): in debug builds it breaks into the debugger; in release
unit-test builds it maps to gtest ``EXPECT_TRUE`` — i.e. library-internal
invariants surface through the test framework. Here: ``sortx_assert``
raises in debug mode (``SORTX_DEBUG=1`` or ``set_debug(True)``) and is
free otherwise; ``debug_validate`` optionally cross-checks engine outputs
against the golden oracle (the analog of the reference's debug-mode
forced syncs that localize failures, ``AdlKernelUtilsCL.inl:660-662``).
"""

from __future__ import annotations

import os
from typing import Callable

from .log import log_error

__all__ = ["sortx_assert", "set_debug", "debug_enabled", "SortxError",
           "CapacityError"]

_DEBUG = bool(int(os.environ.get("SORTX_DEBUG", "0")))


class SortxError(AssertionError):
    """Raised by sortx_assert in debug mode."""


class CapacityError(MemoryError):
    """A requested single-device operation cannot fit device memory.

    The typed replacement for the reference's transparent >max-alloc
    host-backed buffers (``AdlCL.inl:373-378``): the message carries the
    computed limit and points at ``sortx.sort_large``, the host-staged
    out-of-core path.
    """


def set_debug(enable: bool) -> None:
    global _DEBUG
    _DEBUG = enable


def debug_enabled() -> bool:
    return _DEBUG


def sortx_assert(cond, msg: str = "", lazy: Callable[[], str] | None = None):
    """Debug-gated assert. ``lazy`` defers message construction."""
    if not _DEBUG:
        return
    ok = bool(cond() if callable(cond) else cond)
    if not ok:
        text = msg or (lazy() if lazy else "assertion failed")
        log_error(f"SORTX_ASSERT: {text}")
        raise SortxError(text)
