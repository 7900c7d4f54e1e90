"""Runtime layer tests (Adl-analog capabilities, SURVEY §2.3/§5)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import sortx
from sortx.runtime import (Buffer, DeviceConfig, Launcher, MirroredArray,
                           MirrorState, Stopwatch, allocate_device,
                           device_count, replay, toggle_profiling)


def test_device_allocate_and_introspect():
    dev = allocate_device(DeviceConfig())
    assert dev.n_cores >= 1
    assert device_count() >= 1
    dev.wait_for_completion()
    dev.check_leaks()


def test_buffer_roundtrip(rng):
    dev = allocate_device()
    buf = Buffer(dev, jnp.uint32, 1024)
    host = rng.randint(0, 2**32, size=1024, dtype=np.uint32)
    buf.write(host)
    assert np.array_equal(buf.read(), host)
    assert dev.memory_usage == 1024 * 4
    buf.destroy()
    dev.check_leaks()


def test_buffer_fill_clear_and_resize():
    dev = allocate_device()
    buf = Buffer(dev, jnp.int32, 256)
    buf.fill(7)
    assert np.all(buf.read() == 7)
    buf.clear()
    assert np.all(buf.read() == 0)
    buf.set_size(512)  # setSize does NOT preserve contents (Adl/Adl.inl:331)
    assert buf.size == 512
    buf.destroy()
    dev.check_leaks()


def test_buffer_device_to_device_copy(rng):
    dev = allocate_device()
    a, b = Buffer(dev, jnp.uint32, 128), Buffer(dev, jnp.uint32, 128)
    host = rng.randint(0, 2**32, size=128, dtype=np.uint32)
    a.write(host)
    b.write_buffer(a)
    assert np.array_equal(b.read(), host)
    a.destroy(); b.destroy()
    dev.check_leaks()


def test_buffer_leak_detected():
    dev = allocate_device()
    buf = Buffer(dev, jnp.uint32, 64)
    with pytest.raises(RuntimeError, match="leak"):
        dev.check_leaks()
    buf.destroy()
    dev.check_leaks()


def test_buffer_map_semantics(rng):
    dev = allocate_device()
    buf = Buffer(dev, jnp.uint32, 64)
    host = buf.get_host_ptr()
    host[:] = np.arange(64, dtype=np.uint32)
    buf.return_host_ptr(host)
    assert np.array_equal(buf.read(), np.arange(64, dtype=np.uint32))
    buf.destroy()
    dev.check_leaks()


def test_mirrored_array_coherence(rng):
    arr = MirroredArray(np.uint32, 128)
    arr[0:4] = [1, 2, 3, 4]
    assert arr.state == MirrorState.CPU_DIRTY
    dev_arr = arr.device_view()  # sync to device
    assert arr.state == MirrorState.CLEAN
    arr.set_device_result(dev_arr * 2)
    assert arr.state == MirrorState.GPU_DIRTY
    assert arr[1] == 4  # pulls back from device
    arr.set_size(256)   # grows preserving contents
    assert arr[1] == 4 and arr.size == 256


def test_stopwatch_splits():
    sw = Stopwatch()
    sw.start()
    x = jnp.arange(1024) * 2
    sw.split(x)
    sw.stop()
    assert sw.get_ms() >= 0
    assert len(sw.split_times_ms()) == 2


def test_launcher_profiling_csv(tmp_path, rng):
    csv = str(tmp_path / "prof.csv")
    toggle_profiling(True, csv)
    try:
        launch = Launcher(lambda k: sortx.sort(k), "sort_u32")
        keys = jnp.asarray(rng.randint(0, 2**32, size=1024, dtype=np.uint32))
        launch(keys)
        lines = open(csv).read().strip().splitlines()
        # the wrapper's row plus the library's own op row (sortx.sort is
        # itself @profiled since round 5)
        assert sum(l.startswith("sort_u32,") for l in lines) == 1
        assert any(l.startswith("sort,") for l in lines)
    finally:
        toggle_profiling(False)


def test_launcher_capture_replay(tmp_path, rng):
    """serializeToFile/deserializeFromFile analog round-trip."""
    path = str(tmp_path / "launch.npz")
    launch = Launcher(lambda k: sortx.sort(k), "sort_u32",
                      static_config={"sort_bits": 32})
    keys = jnp.asarray(rng.randint(0, 2**32, size=2048, dtype=np.uint32))
    out1 = launch.capture(path, keys)
    out2 = replay(path, {"sort_u32": launch.fn})
    assert np.array_equal(np.asarray(out1), np.asarray(out2))


def test_log_writer(tmp_path):
    from sortx.utils.log import Channel, LogWriter
    lw = LogWriter(str(tmp_path / "t.log"), Channel.ERROR)
    lw.write(Channel.ERROR, "boom")
    lw.write(Channel.DEBUG, "hidden")  # filtered by channel mask
    lw.close()
    content = open(tmp_path / "t.log").read()
    assert "boom" in content and "hidden" not in content


def test_math_helpers():
    from sortx.utils.math import cdiv, is_pow2, next_multiple_of, next_pow2
    assert cdiv(5, 2) == 3
    assert next_pow2(1000) == 1024 and next_pow2(1) == 1
    assert next_multiple_of(300, 256) == 512
    assert is_pow2(256) and not is_pow2(257)


def test_parallel_primitives_facade(rng):
    """Pprims-shaped facade: in-place buffer semantics."""
    from sortx import ParallelPrimitives
    from sortx.runtime import Buffer, allocate_device

    dev = allocate_device()
    pp = ParallelPrimitives(dev)
    keys = rng.randint(0, 2**32, size=1024, dtype=np.uint32)
    kbuf = Buffer(dev, jnp.uint32, 1024)
    kbuf.write(keys)
    pp.radix_sort(kbuf)
    assert np.array_equal(kbuf.read(), np.sort(keys))

    vals = np.arange(512, dtype=np.uint32)
    kb2, vb2 = Buffer(dev, jnp.uint32, 512), Buffer(dev, jnp.uint32, 512)
    kb2.write(keys[:512]); vb2.write(vals)
    pp.radix_sort_kv(kb2, vb2)
    order = np.argsort(keys[:512], kind="stable")
    assert np.array_equal(vb2.read(), order.astype(np.uint32))

    src, dst = Buffer(dev, jnp.int32, 1000), Buffer(dev, jnp.int32, 1000)
    xs = rng.randint(0, 50, size=1000).astype(np.int32)
    src.write(xs)
    total = pp.scan(dst, src, with_total=True)
    assert np.array_equal(dst.read(), np.cumsum(xs) - xs)
    assert int(total) == int(xs.sum())

    # u32 dst: the returned total matches dst's dtype (the reference's u32
    # sum-out contract, Pprims.h:35; ADVICE.md round 1).
    usrc, udst = Buffer(dev, jnp.uint32, 256), Buffer(dev, jnp.uint32, 256)
    uxs = rng.randint(0, 50, size=256).astype(np.uint32)
    usrc.write(uxs)
    utotal = pp.scan(udst, usrc, with_total=True)
    assert utotal.dtype == jnp.uint32
    assert int(utotal) == int(uxs.sum())

    for b in (kbuf, kb2, vb2, src, dst, usrc, udst):
        b.destroy()
    dev.check_leaks()


def test_profiler_trace(tmp_path):
    from sortx.runtime import profiler
    with profiler.trace(str(tmp_path / "tr")):
        with profiler.annotate("op"):
            jnp.arange(128).sum().block_until_ready()
    assert any((tmp_path / "tr").iterdir())


def test_profile_op_measures_and_logs_csv(tmp_path, rng):
    from sortx.runtime import profiler

    csv = str(tmp_path / "prof.csv")
    keys = jnp.asarray(rng.randint(0, 2**32, size=4096, dtype=np.uint32))
    toggle_profiling(True, csv)
    try:
        ms = profiler.profile_op(sortx.sort, keys, iters=2, label="sort4k")
    finally:
        toggle_profiling(False)
    assert ms >= 0.0
    lines = open(csv).read().strip().splitlines()
    assert sum(l.startswith("op:sort4k,") for l in lines) == 1
    # without the toggle: measured but not written (and the library op
    # rows stop too)
    n_before = len(lines)
    ms2 = profiler.profile_op(sortx.sort, keys, iters=2)
    assert ms2 >= 0.0
    assert len(open(csv).read().strip().splitlines()) == n_before


def test_warmup_compiles():
    from sortx.runtime import warmup
    warmup(sizes=(1024,), kv=True, scan_too=True)


def test_library_ops_emit_profile_rows(tmp_path, rng):
    """Round-4 VERDICT missing #1: a PLAIN library call (no user
    Launcher wrapping) must emit CSV rows when profiling is toggled —
    true parity with the reference's per-launch profiling
    (AdlKernelUtilsCL.inl:664-677)."""
    csv = str(tmp_path / "prof.csv")
    keys = jnp.asarray(rng.randint(0, 2**32, size=4096, dtype=np.uint32))
    vals = jnp.arange(4096, dtype=jnp.uint32)
    xs = jnp.asarray(rng.randint(0, 50, size=4096).astype(np.int32))
    toggle_profiling(True, csv)
    try:
        sortx.sort(keys)
        sortx.sort_kv(keys, vals)
        sortx.scan(xs)
        sortx.merge(jnp.sort(keys[:2048]), jnp.sort(keys[2048:]))
    finally:
        toggle_profiling(False)
    lines = open(csv).read().strip().splitlines()
    for op in ("sort,", "sort_kv,", "scan,", "merge,"):
        assert any(l.startswith(op) for l in lines), (op, lines)
    # rows carry ms + shapes
    name, ms, shapes = lines[0].split(",", 2)
    assert float(ms) >= 0.0 and "uint32" in shapes


def test_profile_rows_not_emitted_under_user_jit(tmp_path, rng):
    """Ops traced inside a user jit compile into one program and cannot
    be host-timed; profiling must neither crash nor write bogus rows."""
    import jax

    csv = str(tmp_path / "prof.csv")
    keys = jnp.asarray(rng.randint(0, 2**32, size=4096, dtype=np.uint32))
    f = jax.jit(lambda k: sortx.sort(k))
    toggle_profiling(True, csv)
    try:
        out = f(keys)
        out.block_until_ready()
    finally:
        toggle_profiling(False)
    assert np.array_equal(np.asarray(out), np.sort(np.asarray(keys)))
    assert not os.path.exists(csv) or open(csv).read().strip() == ""


def test_profiling_kernel_level_rows_engine_passes(tmp_path, rng):
    """level="kernel": internal launches wrapped with
    ``profiled(name, level="kernel")`` each emit a row beside the public
    op's — the analog of the reference profiling each enqueued kernel —
    and emit none at the default "op" level."""
    from sortx.runtime.launcher import profiled

    csv = str(tmp_path / "prof.csv")
    keys = jnp.asarray(rng.randint(0, 2**32, size=8192, dtype=np.uint32))
    inner = profiled("demo.inner_pass", level="kernel")(
        lambda k: sortx.sort(k))
    toggle_profiling(True, csv, level="kernel")
    try:
        out = inner(keys)
    finally:
        toggle_profiling(False, level="op")
    assert np.array_equal(np.asarray(out), np.sort(np.asarray(keys)))
    lines = open(csv).read().strip().splitlines()
    assert any(l.startswith("demo.inner_pass,") for l in lines), lines
    assert any(l.startswith("sort,") for l in lines), lines

    csv2 = str(tmp_path / "prof_op.csv")
    toggle_profiling(True, csv2)
    try:
        inner(keys)
    finally:
        toggle_profiling(False)
    lines = open(csv2).read().strip().splitlines()
    assert not any(l.startswith("demo.inner_pass") for l in lines), lines
    assert any(l.startswith("sort,") for l in lines), lines


def test_capture_next_op_and_replay_op(tmp_path, rng):
    """Round-4 VERDICT missing #2: the library's own launches register
    for capture/replay — arm a one-shot capture, call a PLAIN public
    op, replay from the file by op name (no user registry)."""
    from sortx.runtime import capture_next_op, replay_op

    path = str(tmp_path / "cap.npz")
    keys = jnp.asarray(rng.randint(0, 2**32, size=4096, dtype=np.uint32))
    capture_next_op(path)
    out1 = sortx.sort(keys, 16)
    assert os.path.exists(path)
    out2 = replay_op(path)
    assert np.array_equal(np.asarray(out1), np.asarray(out2))
    # one-shot: the next call must NOT overwrite the capture
    mtime = os.path.getmtime(path)
    sortx.sort(keys)
    assert os.path.getmtime(path) == mtime

    # kwargs incl. a Config dataclass round-trip
    path2 = str(tmp_path / "cap2.npz")
    cfg = sortx.Config(dist_local_merge="rank")
    vals = jnp.arange(4096, dtype=jnp.uint32)
    capture_next_op(path2, match="sort_kv")
    ks1, vs1 = sortx.sort_kv(keys, vals, config=cfg)
    ks2, vs2 = replay_op(path2)
    assert np.array_equal(np.asarray(ks1), np.asarray(ks2))
    assert np.array_equal(np.asarray(vs1), np.asarray(vs2))


def test_capture_match_filter_skips_nonmatching(tmp_path, rng):
    from sortx.runtime import capture_next_op

    path = str(tmp_path / "cap.npz")
    keys = jnp.asarray(rng.randint(0, 2**32, size=2048, dtype=np.uint32))
    capture_next_op(path, match="scan")
    sortx.sort(keys)                       # filtered out
    assert not os.path.exists(path)
    sortx.scan(jnp.asarray(np.arange(2048, dtype=np.int32)))
    assert os.path.exists(path)


def test_capture_array_kwarg_replays(tmp_path, rng):
    """Round-5 review: array-valued KEYWORD args must survive the
    capture/replay round trip (they were stored but never restored)."""
    from sortx.runtime import capture_next_op, replay_op

    path = str(tmp_path / "cap.npz")
    keys = jnp.asarray(rng.randint(0, 2**32, size=2048, dtype=np.uint32))
    vals = jnp.arange(2048, dtype=jnp.uint32)
    capture_next_op(path)
    ks1, vs1 = sortx.sort_kv(keys, values=vals)
    ks2, vs2 = replay_op(path)
    assert np.array_equal(np.asarray(ks1), np.asarray(ks2))
    assert np.array_equal(np.asarray(vs1), np.asarray(vs2))


def test_capture_unserializable_arg_skips_not_crashes(tmp_path, rng):
    """Round-5 review: an armed capture must never fail the USER'S op —
    lexsort's list-of-arrays argument is not capturable, so the capture
    is skipped and the op runs normally."""
    from sortx.runtime import capture_next_op

    path = str(tmp_path / "cap.npz")
    a = jnp.asarray(rng.randint(0, 16, size=1024).astype(np.uint32))
    b = jnp.asarray(rng.randint(0, 16, size=1024).astype(np.uint32))
    capture_next_op(path)
    out = sortx.lexsort([a, b])
    assert out.shape == (1024,)
    assert not os.path.exists(path)
