"""Kernel launch wrapper: profiling + capture/replay.

Analog of ``Launcher`` / ``LauncherCL``
(``Adl/AdlKernel.h:59-143``, ``Adl/CL/AdlKernelUtilsCL.inl:541-791``).
JAX's ``jit`` already subsumes arg binding and dispatch; what this layer
adds — the parts of the reference with no JAX builtin — is:

  - per-launch CSV profiling (``Device::toggleProfiling`` ->
    ``ProfileCL.<device>.csv`` with kernel name, ms, shape;
    ``AdlKernelUtilsCL.inl:664-677``), via forced sync + host clock,
    exactly the reference's debug recipe;
  - launch capture to disk and replay (``serializeToFile`` /
    ``deserializeFromFile``, ``AdlKernelUtilsCL.inl:680-791``): dump every
    input array + static config of one launch to an ``.npz`` for offline
    repro, and re-run it later.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Any, Callable, Optional

import jax
import numpy as np

from ..utils.log import Channel, log

__all__ = ["Launcher", "replay", "toggle_profiling", "profiling_enabled",
           "profiling_level", "profile_call", "profiled",
           "capture_next_op", "replay_op"]

_PROFILE = {"enabled": False, "path": None, "level": "op"}
_LEVELS = ("op", "kernel")
# One-shot internal-launch capture (serializeToFile analog for launches
# the LIBRARY makes, AdlKernelUtilsCL.inl:680-734): armed by
# capture_next_op, consumed by the first matching @profiled op /
# profile_call kernel launch.
_CAPTURE: dict = {"path": None, "match": None}


def toggle_profiling(enable: bool, csv_path: Optional[str] = None,
                     level: Optional[str] = None) -> None:
    """Analog of Device::toggleProfiling (Adl/Adl.h:142,153).

    When enabled, EVERY eager public library call (``sortx.sort``,
    ``sort_kv``, ``scan``, ``dist_sort``, ...) appends a CSV row
    ``name,ms,shapes`` — the reference's per-launch recipe
    (AdlKernelUtilsCL.inl:664-677: force-sync around the launch, host
    clock). ``level="kernel"`` additionally rows internal launches
    wrapped with ``profiled(name, level="kernel")`` — the analog of the
    reference profiling each enqueued kernel rather than each Pprims
    call. Ops traced inside a USER ``jax.jit`` cannot be host-timed
    (they are compiled into one program; that is what
    ``runtime.profiler``'s xprof traces are for) — profiling rows come
    from eager calls, where each launch is host-dispatched exactly like
    the reference's.
    """
    _PROFILE["enabled"] = enable
    if csv_path:
        _PROFILE["path"] = csv_path
    if level is not None:
        if level not in _LEVELS:
            raise ValueError(f"profiling level must be one of {_LEVELS}")
        _PROFILE["level"] = level


def profiling_enabled() -> bool:
    return _PROFILE["enabled"]


def profiling_level() -> str:
    return _PROFILE["level"]


def _has_tracer(tree) -> bool:
    return any(isinstance(leaf, jax.core.Tracer)
               for leaf in jax.tree_util.tree_leaves(tree))


def _force(tree) -> None:
    """Wait until every array in ``tree`` has been computed."""
    jax.block_until_ready([l for l in jax.tree_util.tree_leaves(tree)
                           if isinstance(l, jax.Array)])


def _shapes_of(tree) -> str:
    return ";".join(f"{tuple(a.shape)}/{a.dtype}"
                    for a in jax.tree_util.tree_leaves(tree)
                    if hasattr(a, "shape") and a.shape != ())


def _append_row(name: str, ms: float, shapes: str) -> None:
    with open(_profile_path(), "a") as f:
        f.write(f"{name},{ms:.6f},{shapes}\n")
    log(f"launch {name}: {ms:.3f} ms", Channel.PERF)


def capture_next_op(path: str, match: Optional[str] = None) -> None:
    """Arm a ONE-SHOT capture of the next library launch.

    The next eager ``@profiled`` op call (or, with profiling at
    ``level="kernel"``, internal engine launch) whose name starts with
    ``match`` (None = any) dumps its full inputs + static config to
    ``path`` as an ``.npz`` and then runs normally — the analog of the
    reference's mid-pipeline ``serializeToFile``
    (``Adl/CL/AdlKernelUtilsCL.inl:680-734``), which snapshots one
    kernel launch's buffers for offline repro. Public-op captures
    replay cross-process via ``replay_op(path)`` (the op name IS the
    registry); kernel-level captures carry the raw buffers for
    inspection and replay through ``replay(path, registry)`` with a
    caller-supplied callable."""
    _CAPTURE["path"] = path
    _CAPTURE["match"] = match


def _maybe_capture(name: str, args, kw) -> None:
    if _CAPTURE["path"] is None:
        return
    if _CAPTURE["match"] is not None and not name.startswith(
            _CAPTURE["match"]):
        return
    path, _CAPTURE["path"] = _CAPTURE["path"], None
    _CAPTURE["match"] = None
    import dataclasses

    arrays, scalars = {}, {}
    for i, a in enumerate(args):
        if hasattr(a, "shape"):
            arrays[f"arg{i}"] = np.asarray(a)
        elif hasattr(a, "item"):       # numpy scalar -> JSON-safe
            scalars[f"arg{i}"] = a.item()
        elif isinstance(a, (int, float, bool, str, type(None))):
            scalars[f"arg{i}"] = a
        else:
            # Not capturable (e.g. lexsort's list of arrays): skip the
            # capture rather than failing the USER'S op call.
            log(f"capture of {name} skipped: arg{i} "
                f"({type(a).__name__}) is not serializable", Channel.IO)
            return
    kwmeta = {}
    array_kwargs = []
    for k, v in kw.items():
        if hasattr(v, "shape"):
            arrays[f"kw_{k}"] = np.asarray(v)
            array_kwargs.append(k)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            kwmeta[k] = {"__dataclass__": type(v).__name__,
                         "fields": dataclasses.asdict(v)}
        elif isinstance(v, (int, float, bool, str, type(None))):
            kwmeta[k] = v
        else:
            kwmeta[k] = {"__repr__": repr(v)}
    meta = {"name": name, "scalars": scalars, "n_args": len(args),
            "kwargs": kwmeta, "array_kwargs": array_kwargs,
            "static_config": {}}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    log(f"captured launch {name} -> {path}", Channel.IO)


def replay_op(path: str):
    """Re-run a captured LIBRARY op by name (no user registry needed —
    every ``@profiled`` public op is addressable as ``sortx.<name>``).
    Reconstructs array args, scalar args, and a ``Config`` kwarg."""
    import sortx

    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    fn = getattr(sortx, meta["name"], None)
    if fn is None:
        raise KeyError(f"captured launch {meta['name']!r} is not a "
                       f"public sortx op; use replay(path, registry)")
    args: list = []
    for i in range(meta["n_args"]):
        key = f"arg{i}"
        args.append(jax.numpy.asarray(data[key]) if key in data
                    else meta["scalars"][key])
    kw = {}
    for k in meta.get("array_kwargs", []):
        kw[k] = jax.numpy.asarray(data[f"kw_{k}"])
    for k, v in meta.get("kwargs", {}).items():
        if isinstance(v, dict) and v.get("__dataclass__") == "Config":
            from ..config import Config
            kw[k] = Config(**v["fields"])
        elif isinstance(v, dict) and "__repr__" in v:
            continue       # non-serializable kwarg: fall back to default
        else:
            kw[k] = v
    return fn(*args, **kw)


def profile_call(name: str, fn: Callable, *args, _level: str = "op", **kw):
    """Run ``fn(*args, **kw)``; when profiling is active at ``_level``
    and the call is eager (no tracers), time it with the reference's
    sync-around-launch recipe and append a CSV row. Also services an
    armed ``capture_next_op``."""
    eager = not _has_tracer((args, kw))
    if eager and _CAPTURE["path"] is not None and (
            _level == "op" or _PROFILE["level"] == "kernel"):
        _maybe_capture(name, args, kw)
    if (not _PROFILE["enabled"]
            or _LEVELS.index(_level) > _LEVELS.index(_PROFILE["level"])
            or not eager):
        return fn(*args, **kw)
    _force(args)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _force(out)
    ms = (time.perf_counter() - t0) * 1e3
    _append_row(name, ms, _shapes_of(args))
    return out


def profiled(name: str, level: str = "op"):
    """Decorator wiring a library op into ``toggle_profiling`` and
    ``capture_next_op``. Zero overhead when both are off (two dict
    lookups)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not _PROFILE["enabled"] and _CAPTURE["path"] is None:
                return fn(*args, **kw)
            return profile_call(name, fn, *args, _level=level, **kw)
        return wrapper
    return deco


def _profile_path() -> str:
    if _PROFILE["path"] is None:
        dev = jax.devices()[0]
        kind = getattr(dev, "device_kind", "dev").replace(" ", "_")
        _PROFILE["path"] = f"Profile.{kind}.csv"
    return _PROFILE["path"]


class Launcher:
    """Wraps a jitted callable with profiling and capture hooks.

    Unlike the reference's per-launch arg binding (setBuffers/setConst,
    ``Adl/AdlKernel.inl:240-293``), args are plain Python calls; the
    Launcher records them when capture or profiling is on.
    """

    def __init__(self, fn: Callable, name: str, *,
                 static_config: Optional[dict] = None):
        self.fn = fn
        self.name = name
        self.static_config = static_config or {}

    def __call__(self, *args):
        if not _PROFILE["enabled"]:
            return self.fn(*args)
        # Reference recipe: sync before, run, sync after, host clock
        # (AdlKernelUtilsCL.inl:664-677 forces finish around the launch).
        jax.block_until_ready(args)
        t0 = time.perf_counter()
        out = self.fn(*args)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) * 1e3
        shapes = ";".join(f"{a.shape}/{a.dtype}" for a in args
                          if hasattr(a, "shape"))
        with open(_profile_path(), "a") as f:
            f.write(f"{self.name},{ms:.6f},{shapes}\n")
        log(f"launch {self.name}: {ms:.3f} ms", Channel.PERF)
        return out

    # -- capture/replay (serializeToFile analog) ----------------------
    def capture(self, path: str, *args) -> Any:
        """Run the launch AND dump its full inputs + config to ``path``.

        Analog of LauncherCL::serializeToFile
        (``Adl/CL/AdlKernelUtilsCL.inl:680-734``), which dumps every bound
        buffer + scalar + grid dims to a binary file.
        """
        arrays = {f"arg{i}": np.asarray(a) for i, a in enumerate(args)
                  if hasattr(a, "shape")}
        scalars = {f"arg{i}": a for i, a in enumerate(args)
                   if not hasattr(a, "shape")}
        meta = {
            "name": self.name,
            "static_config": self.static_config,
            "scalars": scalars,
            "n_args": len(args),
        }
        np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
        return self.fn(*args)


def replay(path: str, registry: dict[str, Callable]) -> Any:
    """Re-run a captured launch (deserializeFromFile analog,
    ``Adl/CL/AdlKernelUtilsCL.inl:736-791``).

    ``registry`` maps launch names to callables (the reference re-binds the
    kernel by name through KernelManager).
    """
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    fn = registry[meta["name"]]
    args: list[Any] = []
    for i in range(meta["n_args"]):
        key = f"arg{i}"
        if key in data:
            args.append(jax.numpy.asarray(data[key]))
        else:
            args.append(meta["scalars"][key])
    return fn(*args)
