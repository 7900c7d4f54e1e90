"""Device tracing hooks.

The reference's third profiling tier is driver-level tracing (per-launch
CSV + command-queue profiling, SURVEY §5); the equivalent here is
XLA's profiler (xprof/tensorboard traces). This module wraps it with the
same toggle ergonomics as ``toggle_profiling``.
"""

from __future__ import annotations

import contextlib
import os
import time

import jax

from ..utils.log import Channel, log

__all__ = ["trace", "start_trace", "stop_trace", "annotate", "profile_op"]

_DEFAULT_DIR = os.environ.get("SORTX_TRACE_DIR", os.path.join(
    os.path.dirname(__file__), "..", "..", ".sortx_trace"))


def start_trace(log_dir: str | None = None) -> str:
    """Begin an xprof trace (view with tensorboard/xprof)."""
    log_dir = log_dir or _DEFAULT_DIR
    jax.profiler.start_trace(log_dir)
    log(f"trace started -> {log_dir}", Channel.PERF)
    return log_dir


def stop_trace() -> None:
    jax.profiler.stop_trace()
    log("trace stopped", Channel.PERF)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Context manager: trace everything inside."""
    d = start_trace(log_dir)
    try:
        yield d
    finally:
        stop_trace()


def annotate(name: str):
    """Named region that shows up in the trace timeline."""
    return jax.profiler.TraceAnnotation(name)


def profile_op(fn, *args, iters: int = 4, label: str | None = None,
               warmup: bool = True) -> float:
    """Measured milliseconds per call of ``fn(*args)``.

    The device-timing primitive the reference gets from its Stopwatch +
    forced-finish recipe (``Adl/CL/AdlKernelUtilsCL.inl:664-677``): the
    first call compiles outside the clock, then each call is timed to
    ``block_until_ready``. With profiling toggled on
    (``runtime.toggle_profiling``) the result is appended to the same
    CSV as per-launch rows, tagged ``op``.
    """
    if warmup:
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    ms = (time.perf_counter() - t0) / iters * 1e3

    name = label or getattr(fn, "__name__", "op")
    log(f"profile_op {name}: {ms:.3f} ms ({iters} iters)", Channel.PERF)
    from .launcher import _PROFILE, _profile_path

    if _PROFILE["enabled"]:
        shapes = ";".join(f"{a.shape}/{a.dtype}" for a in args
                          if hasattr(a, "shape"))
        with open(_profile_path(), "a") as f:
            f.write(f"op:{name},{ms:.6f},{shapes}\n")
    return ms
