"""Multi-chip distributed stable sort (new scope; SURVEY §7 S5).

The reference is strictly single-device (SURVEY §2.6: "No multi-queue,
multi-device, multi-process, or network parallelism of any kind"); this
module is the new-scope distributed layer from BASELINE.json: keys
partitioned across a 1D device mesh, one skew-aware repartition, local
sorts, and an exact rebalance — stability and ordering bit-identical to the
single-chip sort.

Algorithm: regular-sample sort (PSRS) with exact stability.
  1. Local stable sort per shard (by masked key; full key + payload ride).
  2. Regular samples (every m/(S+1)-th of the sorted shard) -> all_gather ->
     global splitters. Elements are compared as (key, shard, local_rank)
     lexicographically, which equals the global stable order, so duplicate-
     heavy (skewed) keys split EXACTLY: an all-equal-keys input still
     partitions into balanced rank ranges. The PSRS regular-sampling theorem
     deterministically bounds any partition below m + d*m/(s+1) + (s+d),
     so a fixed m+slack receive buffer never overflows — no dynamic
     shapes (see _recv_buf_len). Full-bit keys-only sorts take a fast
     path with no position lane at all (stability is unobservable on a
     u32 multiset; splitter tie-breaks use sorted-shard ranks).
  3. Dense all-to-all of padded cells plus a gather. ``use_ragged=True``
     runs the ragged exchange through the ``_ragged_impl`` seam instead;
     with no collective installed there it raises (see
     ``_RAGGED_REFUSED``).
  4. Local stable merge of the received runs.
  5. Exact rebalance to even [n/D] output shards (second, boundary-only
     ragged exchange), so the output contract matches the input: an evenly
     sharded, globally sorted array.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Config, default_config
from ..ops.dispatch import resolve
from ..runtime.launcher import profiled
from ..utils.math import cdiv
from .mesh import AXIS, make_sort_mesh

__all__ = ["dist_sort", "dist_sort_kv", "dist_sort_padded",
           "dist_sort_kv_padded"]

# Plain int, NOT jnp.uint32: a module-level jax array would initialize
# the backend at import time (breaking later platform overrides).
_SENTINEL = 0xFFFFFFFF

# Witness: which exchange the last dist_sort* call used ("ragged" =
# lax.ragged_all_to_all, "dense" = pad-to-max fallback, "single" = D=1
# shortcut). The multichip dryrun records this, so every run says
# which path it actually validated.
last_exchange: str | None = None

# Witness: which step-5 local merge the last dist_sort* call used
# ("rank" = searchsorted co-ranking k-way merge, "native" = csrc k-way
# merge, "sort" = full re-sort of the receive buffer, "single" = D=1
# shortcut).
last_local_merge: str | None = None


# The collective that use_ragged=True runs, with the signature of
# lax.ragged_all_to_all. None refuses use_ragged=True: XLA:CPU does not
# implement ragged-all-to-all, and on four NVIDIA H100s (JAX 0.9) the
# real collective returned wrong results for all-equal keys (and ran
# 5-12x slower than the dense exchange). Tests install
# _emulate_ragged_all_to_all, so the EXACT argument contract the ragged
# path constructs (offsets/sizes in _shard_sort) still drives execution.
_ragged_impl = None
_RAGGED_REFUSED = (
    "use_ragged=True has no ragged collective to run: XLA:CPU does not "
    "implement lax.ragged_all_to_all, and on NVIDIA H100s it returned "
    "wrong results for all-equal keys; the default dense exchange is "
    "exact on every backend")


def _emulate_ragged_all_to_all(operand, output, input_offsets, send_sizes,
                               output_offsets, recv_sizes, *,
                               axis_name: str):
    """Executable spec of ``lax.ragged_all_to_all`` over dense
    collectives — same signature, same semantics, any backend.

    Contract (jax.lax.ragged_all_to_all): on each device ``i``, segment
    ``operand[input_offsets[j] : input_offsets[j] + send_sizes[j]]`` is
    sent to device ``j``, where it lands at
    ``output[output_offsets[j]_as_seen_by_sender : + send_sizes[j]]``;
    slots of ``output`` not covered by any received segment keep their
    original values. ``recv_sizes[j]`` on the receiver equals
    ``send_sizes[receiver]`` on sender ``j``.

    The emulation ships full-m padded cells through ``lax.all_to_all``
    plus the sender-side ``output_offsets`` (the receiver placement
    information only the sender holds), then masks each received
    segment into the output buffer. O(D*m) wire/compute — a spec, not
    a fast path; the production dense fallback (`_exchange_dense*`)
    stays the perf path where ragged is unavailable."""
    d = send_sizes.shape[0]            # [D] plan vectors: D is static
    m = operand.shape[0]
    out_len = output.shape[0]
    col = lax.broadcasted_iota(jnp.int32, (d, m), 1)
    src_idx = jnp.clip(input_offsets[:, None] + col, 0, m - 1)
    cells = jnp.take(operand, src_idx, axis=0)            # [D, m]
    swapped = lax.all_to_all(cells, axis_name, split_axis=0,
                             concat_axis=0, tiled=False)
    # Receiver needs each sender's placement offset for ME: transmit
    # the sender-side output_offsets through the same collective.
    offs_recv = lax.all_to_all(output_offsets.reshape(d, 1), axis_name,
                               split_axis=0, concat_axis=0,
                               tiled=False).reshape(d)
    t = lax.broadcasted_iota(jnp.int32, (out_len,), 0)

    def body(i, acc):
        off = offs_recv[i]
        k = t - off
        row = lax.dynamic_slice(swapped, (i, 0), (1, m)).reshape(m)
        seg = row[jnp.clip(k, 0, m - 1)]
        return jnp.where((k >= 0) & (k < recv_sizes[i]), seg, acc)

    return lax.fori_loop(0, d, body, output)


def _exchange_ragged(operand, send_sizes, input_offsets, output_offsets,
                     recv_sizes, out_len: int, axis_name: str, fill):
    """Ragged all-to-all of contiguous segments; output buffer [out_len]."""
    out = jnp.full((out_len,) + operand.shape[1:], fill, operand.dtype)
    return _ragged_impl(operand, out, input_offsets, send_sizes,
                        output_offsets, recv_sizes, axis_name=axis_name)


def _exchange_dense(operand, send_sizes, input_offsets, output_offsets,
                    recv_sizes, out_len: int, axis_name: str, fill,
                    axis_size: int):
    """Fallback exchange via pad-to-max all_to_all + gather compaction.

    Used where RaggedAllToAll is not implemented by the backend. Each cell
    is padded to the local shard size m (a shard can send at most its whole
    block to one destination), so correctness never depends on sample
    quality.
    """
    d = axis_size
    m = operand.shape[0]
    col = lax.broadcasted_iota(jnp.int32, (d, m), 1)
    src_idx = jnp.clip(input_offsets[:, None] + col, 0, m - 1)
    cells = jnp.take(operand, src_idx, axis=0)          # [D, m] padded cells
    swapped = lax.all_to_all(cells, axis_name, split_axis=0, concat_axis=0,
                             tiled=False)
    # swapped[i] = segment from shard i (size recv_sizes[i], left-aligned).
    starts = jnp.cumsum(recv_sizes) - recv_sizes        # my recv offsets
    t = lax.broadcasted_iota(jnp.int32, (out_len,), 0)
    row = jnp.searchsorted(starts, t, side="right") - 1
    k = t - starts[row]
    total = jnp.sum(recv_sizes)
    val = swapped[row, jnp.clip(k, 0, m - 1)]
    return jnp.where((t < total) & (k < m), val,
                     jnp.asarray(fill, operand.dtype))


def _exchange_dense_bounded(operand, send_sizes, input_offsets,
                            output_offsets, recv_sizes, out_len: int,
                            axis_name: str, fill, axis_size: int,
                            cap: int):
    """Dense exchange with O(m)-per-shard wire traffic (the full-m
    fallback ships D*m per shard, guaranteeing anti-scaling).

    Cells are padded to a static ``cap`` (caller guards that every
    OFF-diagonal cell fits via ``lax.cond`` on the all-gathered count
    matrix); the diagonal cell — the largest one for near-balanced
    plans — never crosses the wire at all: the receiver reads its own
    segment straight from ``operand``.
    """
    d = axis_size
    m = operand.shape[0]
    me = lax.axis_index(axis_name)
    fillv = jnp.asarray(fill, operand.dtype)
    # Cells as cap-windows (dynamic_slice, not gather — ~an order of
    # magnitude cheaper on XLA:CPU). Right-pad so windows never clamp.
    padded = jnp.concatenate([operand, jnp.full((cap,), fillv,
                                                operand.dtype)])
    cells = jax.vmap(
        lambda o: lax.dynamic_slice(padded, (o,), (cap,)))(input_offsets)
    swapped = lax.all_to_all(cells, axis_name, split_axis=0,
                             concat_axis=0, tiled=False)
    starts = jnp.cumsum(recv_sizes) - recv_sizes      # my recv offsets
    total = jnp.sum(recv_sizes)
    # Ascending overwrite chain: window i writes its full cap span at
    # starts[i]; the garbage overhang past recv_sizes[i] is exactly
    # covered by window i+1 (recv_sizes[i] <= cap for i != me, by the
    # caller's guard), and the final overhang is masked below.
    acc = jnp.full((out_len + cap,), fillv, operand.dtype)

    def body(i, a):
        win = lax.dynamic_slice(swapped, (i, 0), (1, cap)).reshape(cap)
        return lax.dynamic_update_slice(a, win, (starts[i],))

    out = lax.fori_loop(0, d, body, acc)[:out_len]
    t = lax.broadcasted_iota(jnp.int32, (out_len,), 0)
    # Diagonal fix: the self segment may exceed cap (it is the largest
    # cell for near-balanced plans) — rewrite its whole span from a
    # rolled window of my own operand (never on the wire). Valid span
    # indices never wrap: t - starts[me] + input_offsets[me] stays in
    # [0, m) inside the span, and everything else is masked.
    L = max(out_len, m)
    pb = (operand if L == m
          else jnp.concatenate([operand,
                                jnp.full((L - m,), fillv, operand.dtype)]))
    diag = jnp.roll(pb, starts[me] - input_offsets[me])[:out_len]
    out = jnp.where((t >= starts[me]) & (t < starts[me] + recv_sizes[me]),
                    diag, out)
    return jnp.where(t < total, out, fillv)


def _dense_cell_cap(m: int, d: int) -> int:
    """Static off-diagonal cell capacity: 2x the balanced m/D share
    (sampling slack + boundary spill), 8-aligned, never above m."""
    return min(m, max(64, (2 * cdiv(m, d) + 7) // 8 * 8))


def _segment_layout(dest, d: int):
    """dest is monotone per sorted element; return (sizes, offsets) per dest.

    Pure (no collectives); since round 5 this is the executable SPEC of
    the plan, not the production path — _shard_sort computes the same
    sizes/offsets as O(d) boundary differences without materializing
    dest (tests/test_dist_plan.py pins the equivalence with golden and
    randomized plans on every backend).
    """
    offsets = jnp.searchsorted(dest, jnp.arange(d, dtype=dest.dtype),
                               side="left").astype(jnp.int32)
    ends = jnp.searchsorted(dest, jnp.arange(d, dtype=dest.dtype),
                            side="right").astype(jnp.int32)
    return ends - offsets, offsets


def _plan_from_counts(c, me):
    """Receiver-side layout from the gathered count matrix (pure).

    ``c[i, j]`` = elements shard i sends to shard j. Returns
    (send_out_off, recv_sizes) for shard ``me``: where MY segment starts
    inside each receiver's buffer (sum over lower-ranked senders — keeps
    arrival order == global stable order), and how much I receive from
    each sender. Shared by BOTH exchange implementations, so the dense
    CPU path regression-tests the exact plan the ragged path uses.
    """
    prefix_c = jnp.cumsum(c, axis=0) - c
    return prefix_c[me, :], c[:, me]


def _local_sort_keys(mk):
    """Keys-only 1-stream local sort — the fast path for full-bit
    keys-only distributed sorts, where stability is unobservable (the
    sorted u32 multiset is unique). On XLA:CPU a 1-key sort is ~4x
    faster than the 2-key (key, pos) sort (measured 0.33 vs 1.33 s at
    2^22)."""
    return lax.sort(mk)


def _recv_buf_len(m: int, d: int, s: int) -> int:
    """Static receive-buffer bound for PSRS regular sampling.

    Deterministic partition bound: with s regular samples per shard,
    any partition holds < m + d*m/(s+1) + (s + d) elements (each shard
    contributes at most (samples_inside + 1) inter-sample gaps of
    ceil(m/(s+1)); splitters sit s apart in sample rank). Doubling the
    slack term for margin, this replaces the old fixed 2m buffer —
    with the default s >= d^3 the buffer is ~m(1 + 2/d^2), so the
    local merge no longer sorts 2x the data."""
    slack = 2 * (cdiv(d * m, s + 1) + s + d)
    return min(2 * m, (m + slack + 7) // 8 * 8)


def _merge_runs_rank(streams, recv_sizes, recv_total, mask, m: int, d: int):
    """Stable k-way merge of the receive buffer's d left-packed sorted
    runs by direct rank computation: step 5 costs O(buf·d·log m)
    branch-free binary-search work on the KEY LANE ONLY, instead of a
    full multi-stream comparison re-sort of the buffer (which on
    XLA:CPU pays the generic-comparator path: ~4x per extra operand).

    Run i = shard i's contribution (internally in global stable order);
    the global stable order is lexicographic (masked key, run index,
    within-run index) — exactly what the sort path's (masked key,
    buffer position) comparator computes, since runs are placed in
    shard order from offset 0. Each element's output rank is its
    within-run index plus, for every other run, the count of elements
    there that precede it:

        count(run s', elem (k, s, j)) = |{x in run s' : x <  k}|  s' > s
                                        |{x in run s' : x <= k}|  s' < s

    Both counts come from ONE batched searchsorted per run via the
    integer trick count<= k == count< (k+1), with the k = mask wrap
    mapping to the full run length. Payload streams are then permuted
    by pure scatter (the ranks are a permutation, so the scatter is
    unique-index). Invalid tail slots (t >= recv_total) keep rank = t:
    they stay the contiguous tail, matching the sort path's
    position-lane tie-break bit-for-bit.
    """
    buf = streams[0].shape[0]
    mk = streams[0] & mask
    lens = recv_sizes.astype(jnp.int32)
    starts = jnp.cumsum(lens) - lens                        # [d]
    t = lax.iota(jnp.int32, buf)
    # Element t's run: last run whose start <= t (searchsorted 'right'
    # correctly skips zero-length runs sharing a start offset).
    seg = (jnp.searchsorted(starts, t, side="right") - 1).astype(jnp.int32)
    j_in = t - starts[seg]
    # Extract runs as [d, m] sorted rows (a run never exceeds the source
    # shard size m); tails beyond each run's length become the sentinel,
    # which preserves sortedness (counts are clipped to the true length).
    pad = jnp.concatenate([mk, jnp.full((m,), jnp.uint32(_SENTINEL))])
    runs = jax.vmap(lambda s: lax.dynamic_slice(pad, (s,), (m,)))(starts)
    col = lax.broadcasted_iota(jnp.int32, (d, m), 1)
    runs = jnp.where(col < lens[:, None], runs, jnp.uint32(_SENTINEL))
    s_ids = jnp.arange(d, dtype=jnp.int32)
    # count<= for earlier runs == count< of (k+1); k == mask wraps past
    # every maskable key, meaning "count the whole run".
    bump = (s_ids[:, None] < seg[None, :]).astype(jnp.uint32)   # [d, buf]
    q = mk[None, :] + bump
    whole = (bump == 1) & (mk[None, :] == mask)
    cnt = jax.vmap(
        lambda r, qq: jnp.searchsorted(r, qq, side="left")
    )(runs, q).astype(jnp.int32)
    cnt = jnp.minimum(jnp.where(whole, lens[:, None], cnt), lens[:, None])
    cnt = jnp.where(s_ids[:, None] == seg[None, :], j_in[None, :], cnt)
    rank = jnp.sum(cnt, axis=0)
    rank = jnp.where(t < recv_total, rank, t)
    return tuple(
        jnp.zeros_like(s).at[rank].set(s, unique_indices=True,
                                       mode="promise_in_bounds")
        for s in streams)


def _local_stable_sort(streams):
    """Stable sort of parallel streams by (streams[0], streams[1]) where
    streams[1] is a unique position lane — the per-shard local sort
    primitive. Returns the sorted key lane, the permutation, and every
    further stream permuted by it.

    The unique (masked key, position) pair is composed into one u64, so
    the sort has a single operand: XLA hands that to its fast integer
    sort (CUB's radix sort on a GPU, a radix path on the CPU), where any
    extra operand drops it to the generic comparison sort. Value
    streams of any dtype follow by gather and never enter a comparator.
    x64 is enabled only lexically (jax.enable_x64) around explicitly
    typed arrays, so global x64 state is untouched.
    """
    k, pos = streams[0], streams[1]
    with jax.enable_x64(True):
        k64 = (k.astype(jnp.uint64) << 32) | pos.astype(jnp.uint64)
        s = lax.sort(k64)
        p = (s & 0xFFFFFFFF).astype(jnp.int32)
        sk = (s >> 32).astype(jnp.uint32)
    return (sk, p.astype(jnp.uint32)) + tuple(
        jnp.take(t, p) for t in streams[2:])


def _merge_runs_native(streams, recv_sizes, mask, buf: int, d: int):
    """Step-5 via the native parallel k-way merge
    (``csrc/host_sort.cpp sortx_host_merge_u32`` — the same engine the
    out-of-core sort uses) through ``jax.pure_callback``.

    Measured (4-core host): merging d
    left-packed sorted runs runs 4-9x faster than re-sorting with
    XLA:CPU's radix path (d=2 @1M total: 6.1 ms vs 22.3; d=8 @0.5M:
    ~3 ms vs 27.7), because a k-way merge is one output-partitioned
    linear pass instead of a full sort. The merge is stable with ties
    in run order — exactly the (masked key, run, within-run) global
    stable order the sort/tree paths compute. Payload streams are
    permuted by the merged index lane, never entering a comparator.
    Tail slots (>= recv_total) pass through unchanged.
    """
    import numpy as np

    from ..runtime import native

    mk = streams[0] & mask

    def cb(rs, mkh, *payload):
        rs = np.asarray(rs).astype(np.int64)
        off = np.zeros(d + 1, np.int64)
        off[1:] = np.cumsum(rs)
        total = int(off[-1])
        idx = np.arange(total, dtype=np.uint32)
        _, perm = native.host_merge(
            np.ascontiguousarray(np.asarray(mkh)[:total]), off, values=idx)
        perm = perm.astype(np.int64)
        outs = []
        for p in payload:
            p = np.asarray(p)
            o = np.empty_like(p)
            o[:total] = p[:total][perm]
            o[total:] = p[total:]
            outs.append(o)
        return tuple(outs)

    shapes = tuple(jax.ShapeDtypeStruct((buf,), s.dtype) for s in streams)
    return jax.pure_callback(cb, shapes, recv_sizes, mk, *streams)


def _shard_sort(keys, values, *, d: int, m: int, s_samples: int,
                sort_bits: int, axis_name: str, use_ragged: bool,
                cfg: Config):
    """Per-shard body (runs under shard_map). keys/values: [m] local."""
    me = lax.axis_index(axis_name)
    mask = jnp.uint32(_SENTINEL if sort_bits >= 32
                      else (1 << sort_bits) - 1)
    has_values = values is not None
    bounded = (not use_ragged) and cfg.dist_dense_bounded
    cap = _dense_cell_cap(m, d)

    def _exchange_all(operands, fills, send_sizes, input_offsets, out_off,
                      recv_sizes, out_len, cmat):
        """Exchange several parallel streams under one plan. The dense
        path picks bounded vs full-m cells in-graph from the all-gathered
        count matrix (identical on every shard, so the cond can never
        diverge across the collective)."""
        if use_ragged:
            return tuple(
                _exchange_ragged(o, send_sizes, input_offsets, out_off,
                                 recv_sizes, out_len, axis_name, f)
                for o, f in zip(operands, fills))

        def full():
            return tuple(
                _exchange_dense(o, send_sizes, input_offsets, out_off,
                                recv_sizes, out_len, axis_name, f, d)
                for o, f in zip(operands, fills))

        if not bounded or cap >= m:
            return full()

        def bnd():
            return tuple(
                _exchange_dense_bounded(o, send_sizes, input_offsets,
                                        out_off, recv_sizes, out_len,
                                        axis_name, f, d, cap)
                for o, f in zip(operands, fills))

        off_max = jnp.max(jnp.where(jnp.eye(d, dtype=bool), 0, cmat))
        return lax.cond(off_max <= cap, bnd, full)
    # 4-byte value dtypes ride the sort as a u32 view; other widths pass
    # through untouched (the XLA local sort handles mixed dtypes).
    vu32 = (has_values and values.dtype != jnp.uint32
            and values.dtype.itemsize == 4)

    # Full-bit keys-only sorts skip the position lane entirely: the
    # sorted u32 multiset is unique, so stability is unobservable, and
    # the 1-stream local sorts are ~4x cheaper on XLA:CPU. Tie-exact
    # splitting still works — the splitter's rank WITHIN its own sorted
    # shard replaces the original-position lane in the (key, shard,
    # rank) total order.
    fast = not has_values and sort_bits >= 32

    # -- 1. local sort (stable paths: by (masked key, position) — the
    #       unique position lane makes any comparison sort produce the
    #       stable order)
    mk = keys & mask
    if fast:
        smk = _local_sort_keys(mk)
        sfull = smk
        svals = None
    else:
        # The position lane participates in the SORT (the unique
        # tie-break that makes any comparison sort produce the stable
        # order); its sorted output is not consumed — splitter rank
        # math uses sorted-shard indices (step 2), so XLA DCEs it.
        posu = lax.iota(jnp.uint32, m)
        st = [mk, posu] + ([keys] if sort_bits < 32 else []) + (
            [values.view(jnp.uint32) if vu32 else values] if has_values
            else [])
        out = _local_stable_sort(st)
        smk = out[0]
        sfull = out[2] if sort_bits < 32 else smk
        svals = None
        if has_values:
            svals = out[-1].view(values.dtype) if vu32 else out[-1]

    # -- 2. splitters from regular samples ---------------------------
    samp_idx = jnp.array([(i + 1) * m // (s_samples + 1)
                          for i in range(s_samples)], jnp.int32)
    my_k = smk[samp_idx]
    all_k = lax.all_gather(my_k, axis_name).reshape(-1)      # [D*S]
    # Rank lane = the sample's SORTED-shard index — STATIC and identical
    # on every shard, so it needs no collective (each barrier costs real
    # stall time on an oversubscribed virtual mesh). Valid for the
    # stable paths too (round-5; previously they gathered original
    # positions): the rank lane only breaks ties among equal keys
    # WITHIN one shard, where sorted-index order equals original-
    # position order (the local sort is stable), and every shard
    # compares against the identical (key, shard, rank) triple — so the
    # induced global total order is unchanged.
    all_p = jnp.tile(samp_idx, d)
    all_s = jnp.repeat(jnp.arange(d, dtype=jnp.int32), s_samples)
    gk, gs, gp = lax.sort([all_k, all_s, all_p], num_keys=1, is_stable=True)
    spl_rank = jnp.array([(j + 1) * s_samples for j in range(d - 1)],
                         jnp.int32)
    spl_k, spl_s, spl_p = gk[spl_rank], gs[spl_rank], gp[spl_rank]

    # -- 3. partition boundaries (lex (key, shard, rank)) ------------
    # b_j = first sorted index idx of THIS shard with
    # (key[idx], me, idx) >= splitter_j; exact even for all-equal keys
    # (skew). spl_p is the sample's index within its own sorted shard,
    # so the me == spl_s case is spl_p itself. The [m]-long destination
    # vector is NEVER materialized (round-5: the boundary form is the
    # whole plan — dest was monotone, so sizes/offsets are just
    # boundary differences; measured ~90 ms of O(m) passes at
    # d=4/m=2^22 on the CPU mesh).
    lt = jnp.searchsorted(smk, spl_k, side="left").astype(jnp.int32)
    rt = jnp.searchsorted(smk, spl_k, side="right").astype(jnp.int32)
    b = jnp.where(spl_s < me, lt, jnp.where(spl_s > me, rt, spl_p))

    # -- 4. exchange plan (O(d), from the boundaries) ----------------
    input_offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), b])                     # [D]
    ends = jnp.concatenate([b, jnp.full((1,), m, jnp.int32)])
    send_sizes = ends - input_offsets
    c = lax.all_gather(send_sizes, axis_name)                # [D,D] c[i,j]
    send_out_off, recv_sizes = _plan_from_counts(c, me)
    recv_total = jnp.sum(recv_sizes)
    buf = _recv_buf_len(m, d, s_samples)

    # -- exchange payloads -------------------------------------------
    ops1 = (sfull,) + ((svals,) if has_values else ())
    fl1 = (_SENTINEL,) + ((jnp.zeros((), svals.dtype),)
                          if has_values else ())

    def _resort(rf, rv):
        """Full re-sort of a receive buffer (always-correct merge)."""
        if fast:
            mf = _local_sort_keys(rf)
            return mf, mf
        pos2 = lax.iota(jnp.uint32, buf)
        st = [rf & mask, pos2] + ([rf] if sort_bits < 32 else []) + (
            [rv.view(jnp.uint32) if vu32 else rv] if has_values else [])
        merged = _local_stable_sort(st)
        mf = merged[2] if sort_bits < 32 else merged[0]
        if has_values:
            return mf, (merged[-1].view(values.dtype) if vu32
                        else merged[-1])
        return mf, mf

    ex1 = _exchange_all(ops1, fl1, send_sizes, input_offsets,
                        send_out_off, recv_sizes, buf, c)
    r_full = ex1[0]
    r_vals = ex1[1] if has_values else None

    # -- 5. local stable merge. Invalid slots are the contiguous tail
    #       (every receive segment is placed from offset 0), so their
    #       position lane alone sorts them last — even past legitimate
    #       0xffffffff keys — and arrival order (= global stable order)
    #       breaks masked-key ties. The fast path needs neither: fill
    #       slots carry the sentinel key itself, indistinguishable from
    #       (and interchangeable with) legitimate max keys. ------------
    # "auto" = the full RE-SORT. Both alternatives measured NEGATIVE on
    # XLA:CPU in context: "rank" 3-14x slower than the radix-path
    # re-sort (272 vs 28 ms at d=8, m=2^19 — d*log(m) vector-gather
    # steps per element cannot beat a 21 ns/elem native radix sort),
    # and "native" — despite winning 4-9x standalone — loses ~10% end
    # to end under shard_map (611 vs 675 ms at d=2, m=2^22: the
    # pure_callback serializes against XLA:CPU's intra-op pool and the
    # merge's own threads).
    merge_mode = resolve("dist_merge", cfg)

    if merge_mode == "native":
        st2 = (r_full,) + ((r_vals,) if has_values else ())
        mg = _merge_runs_native(st2, recv_sizes, mask, buf, d)
        m_full = mg[0]
        m_vals = mg[1] if has_values else None
    elif merge_mode == "rank":
        st2 = (r_full,) + (
            (r_vals.view(jnp.uint32) if vu32 else r_vals,)
            if has_values else ())
        mg = _merge_runs_rank(st2, recv_sizes, recv_total, mask, m, d)
        m_full = mg[0]
        m_vals = None
        if has_values:
            m_vals = mg[-1].view(values.dtype) if vu32 else mg[-1]
    else:
        m_full, mv = _resort(r_full, r_vals)
        m_vals = mv if has_values else None

    return _rebalance(m_full, m_vals, c, me, recv_total, buf, m, d,
                      has_values, axis_name, _exchange_all)


def _rebalance(m_full, m_vals, c, me, recv_total, buf: int, m: int,
               d: int, has_values: bool, axis_name: str, exchange_all):
    """Step 6: exact rebalance of the merged [buf] buffers to even [m]
    output shards (second, boundary-only exchange).

    Element k of my merged buffer (k < recv_total) sits at global
    position my_g + k and belongs to shard min((my_g+k)//m, d-1), so
    the per-destination boundaries are closed-form — no [buf]-long
    destination vector, no searchsorted (round-5 O(d) plan)."""
    tot_per_shard = jnp.sum(c, axis=0)                       # [D] recv totals
    g = jnp.cumsum(tot_per_shard) - tot_per_shard            # global starts
    my_g = g[me]
    jj = jnp.arange(d, dtype=jnp.int32)
    input_offsets2 = jnp.clip(jj * m - my_g, 0, recv_total).astype(jnp.int32)
    ends2 = jnp.clip((jj + 1) * m - my_g, 0, recv_total)
    # shard d-1 also absorbs any global tail past d*m (dest was clipped
    # to d-1): its end is recv_total unconditionally.
    ends2 = ends2.at[d - 1].set(recv_total)
    send_sizes2 = (ends2 - input_offsets2).astype(jnp.int32)
    # where my segment to shard j starts inside j's final [m] block:
    seg_start_q = my_g + input_offsets2
    send_out_off2 = jnp.clip(seg_start_q - jnp.arange(d) * m, 0, m)
    send_out_off2 = send_out_off2.astype(jnp.int32)
    c2 = lax.all_gather(send_sizes2, axis_name)              # [D,D]
    _, recv_sizes2 = _plan_from_counts(c2, me)
    ops2 = (m_full,) + ((m_vals,) if has_values else ())
    fl2 = (_SENTINEL,) + ((jnp.zeros((), m_vals.dtype),)
                          if has_values else ())
    ex2 = exchange_all(ops2, fl2, send_sizes2, input_offsets2,
                       send_out_off2, recv_sizes2, m, c2)
    if has_values:
        return ex2[0], ex2[1]
    return ex2[0], ex2[0]


def _trim_tail_local(arr, n: int):
    """Slice an evenly-sharded [d*m] array to [n] without replicating.

    Uneven sharded arrays are unrepresentable in this JAX (NamedSharding
    requires divisibility), so a global [n] cannot stay sharded. Round 1
    replicated the whole array on EVERY device (O(n) x D memory); this
    instead slices per-shard on-device and concatenates once — only the
    destination device holds O(n); every other device keeps O(n/D).
    Single-process meshes only (multi-process keeps the replicated path);
    truly scale-safe ragged output = ``dist_sort_padded``.
    """
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start)
    target = shards[0].device
    pieces = []
    for s in shards:
        start = s.index[0].start
        stop = min(s.index[0].stop, n)
        if stop > start:
            data = s.data
            if stop - start != data.shape[0]:
                data = data[: stop - start]       # trim tail pads on-device
            pieces.append(jax.device_put(data, target))
    return jnp.concatenate(pieces)


@functools.lru_cache(maxsize=128)
def _jitted_d1(mesh: Mesh, sort_bits: int, kv: bool):
    """Cached jitted single-chip sort under shard_map for the degenerate
    d=1 mesh (inputs may carry a NamedSharding over it). The jitted
    callable is CACHED on the static signature: a fresh jax.jit per
    call would re-trace every time an eager caller loops."""
    from ..ops.sort_xla import sort_kv_xla, sort_xla

    if not kv:
        fn = lambda k: sort_xla(k, sort_bits)
        mapped = jax.shard_map(fn, mesh=mesh, in_specs=(P(AXIS),),
                               out_specs=P(AXIS), check_vma=False)
    else:
        fn = lambda k, v: sort_kv_xla(k, v, sort_bits)
        mapped = jax.shard_map(fn, mesh=mesh,
                               in_specs=(P(AXIS), P(AXIS)),
                               out_specs=(P(AXIS), P(AXIS)),
                               check_vma=False)
    return jax.jit(mapped)


@functools.lru_cache(maxsize=128)
def _jitted_shard_sort(mesh: Mesh, d: int, m: int, s: int, sort_bits: int,
                       use_ragged: bool, cfg: Config, has_values: bool):
    """Cached jitted PSRS shard_map (see _jitted_d1's rationale)."""
    fn = functools.partial(
        _shard_sort, d=d, m=m, s_samples=s, sort_bits=sort_bits,
        axis_name=AXIS, use_ragged=use_ragged, cfg=cfg)
    if has_values:
        body = lambda k, v: fn(k, v)
        in_specs = (P(AXIS), P(AXIS))
    else:
        body = lambda k: fn(k, None)
        in_specs = (P(AXIS),)
    mapped = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                           out_specs=(P(AXIS), P(AXIS)), check_vma=False)
    ev = NamedSharding(mesh, P(AXIS))
    return jax.jit(mapped, out_shardings=(ev, ev))


def _dist_sort_impl(keys, values, sort_bits: int, mesh: Mesh,
                    use_ragged: bool, s_samples: int | None,
                    padded_out: bool = False,
                    config: Config | None = None):
    global last_exchange, last_local_merge
    if use_ragged and _ragged_impl is None:
        raise ValueError(_RAGGED_REFUSED)
    d = mesh.shape[AXIS]
    if d == 1:
        # Degenerate mesh: the single-chip sort (keys already u32 here).
        last_local_merge = "single"
        last_exchange = "single"
        if values is None:
            out = _jitted_d1(mesh, sort_bits, False)(keys)
            return (out, 0) if padded_out else out
        ks, vs = _jitted_d1(mesh, sort_bits, True)(keys, values)
        return (ks, vs, 0) if padded_out else (ks, vs)
    last_exchange = "ragged" if use_ragged else "dense"
    n = keys.shape[0]
    m = cdiv(n, d)
    pad = d * m - n
    has_values = values is not None
    if pad:
        # Pads sort to the tail among max keys by stability (they hold the
        # highest original indices) — CHECK_BOUNDARY semantics
        # (RadixSortKeyValueKernels.cl:552-563) without a validity lane.
        keys = jnp.concatenate([keys, jnp.full((pad,), _SENTINEL, jnp.uint32)])
        if has_values:
            values = jnp.concatenate(
                [values, jnp.zeros((pad,), values.dtype)])
    # Sampling rate invariant for the 2m receive-buffer bound: either
    # s >= d (PSRS regular-sampling theorem: max partition < m + n/(d*s)
    # <= 2m), or s == m (every element sampled -> partitions are exactly
    # m). All branches below land in one of the two regimes.
    s = s_samples or max(d, min(64, m))
    s = min(s, m)

    cfg = config or default_config()
    if s_samples is None and not use_ragged and cfg.dist_dense_bounded:
        # Bounded dense cells (cap ~4m/D) need the rebalance boundary
        # spill |my_g - me*m| <= ~cap; cumulative sampling deviation is
        # bounded by d^2*m/s, so s >= d^3 keeps it within one cell.
        s = min(m, max(s, d * d * d))
    last_local_merge = resolve("dist_merge", cfg)
    args = (keys, values) if has_values else (keys,)
    # Evenly sharded [d*m] result; pads (largest-key sentinels) sit at the
    # global tail because the rebalance targets [i*m, (i+1)*m) per shard.
    out_k, out_v = _jitted_shard_sort(
        mesh, d, m, s, sort_bits, use_ragged, cfg, has_values)(*args)

    if padded_out:
        return (out_k, out_v, pad) if has_values else (out_k, pad)

    if pad:
        if jax.process_count() == 1:
            out_k = _trim_tail_local(out_k, n)
            if has_values:
                out_v = _trim_tail_local(out_v, n)
        else:
            # Multi-process: per-shard data is not globally addressable;
            # replicate + slice (scale users: dist_sort_padded).
            unshard = NamedSharding(mesh, P(None))
            slc = jax.jit(lambda x: x[:n], out_shardings=unshard)
            out_k = slc(jax.sharding.reshard(out_k, unshard))
            if has_values:
                out_v = slc(jax.sharding.reshard(out_v, unshard))
    if has_values:
        return out_k, out_v
    return out_k


@profiled("dist_sort_padded")
def dist_sort_padded(keys, sort_bits: int = 32, *, descending: bool = False,
                     mesh: Mesh | None = None,
                     config: Config | None = None,
                     use_ragged: bool = False):
    """Scale-safe distributed sort: evenly sharded result, pads kept.

    Returns ``(sorted_padded, pad)``: a [D*ceil(n/D)] array evenly
    sharded over the mesh whose first n elements are the sorted keys and
    whose last ``pad`` elements are order-extreme sentinels (the
    largest key for ascending, the smallest for ``descending=True`` —
    either way the sentinels stay at the global tail). Peak memory is
    O(n/D) per device for ANY n — the unpadded ``dist_sort`` must place
    the ragged [n] result on one device, because uneven sharded arrays
    are unrepresentable (NamedSharding divisibility rule).
    """
    from ..ops.sort import _order_mask, _to_radix_u32

    _validate(keys, sort_bits)
    mesh = mesh or make_sort_mesh()
    k, undo = _to_radix_u32(keys)
    if descending:
        k = k ^ _order_mask(sort_bits)
    out, pad = _dist_sort_impl(k, None, sort_bits, mesh, use_ragged, None,
                               padded_out=True, config=config)
    if descending:
        out = out ^ _order_mask(sort_bits)
    return undo(out), pad


@profiled("dist_sort_kv_padded")
def dist_sort_kv_padded(keys, values, sort_bits: int = 32, *,
                        descending: bool = False,
                        mesh: Mesh | None = None,
                        config: Config | None = None,
                        use_ragged: bool = False):
    """Scale-safe distributed key-value sort; see ``dist_sort_padded``.

    Returns ``(sorted_keys_padded, values_padded, pad)`` (value pads = 0).
    """
    from ..ops.sort import _order_mask, _to_radix_u32

    _validate(keys, sort_bits)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    mesh = mesh or make_sort_mesh()
    k, undo = _to_radix_u32(keys)
    if descending:
        k = k ^ _order_mask(sort_bits)
    ks, vs, pad = _dist_sort_impl(k, values, sort_bits, mesh, use_ragged,
                                  None, padded_out=True, config=config)
    if descending:
        ks = ks ^ _order_mask(sort_bits)
    return undo(ks), vs, pad


def _validate(keys, sort_bits: int):
    """Same argument contract as the single-chip ``sortx.sort``
    (ops/sort.py): without this, partial sort_bits on i32/f32 keys would
    silently sort by low bits of the monotone u32 transform."""
    from ..ops.sort import _check_keys

    _check_keys(keys)
    if not (1 <= sort_bits <= 32):
        raise ValueError("sort_bits must be in 1..32")
    if keys.dtype != jnp.uint32 and sort_bits != 32:
        raise ValueError("partial sort_bits requires uint32 keys "
                         "(the reference's contract, Pprims.cpp:253)")


@profiled("dist_sort")
def dist_sort(keys, sort_bits: int = 32, *, descending: bool = False,
              mesh: Mesh | None = None,
              config: Config | None = None, use_ragged: bool = False):
    """Distributed stable LSD-equivalent sort over a device mesh.

    ``keys``: global 1D u32/i32/f32 array (sharded or unsharded). Returns
    the globally sorted array, evenly sharded over the mesh. Ordering is
    bit-identical to ``sortx.sort`` (and the reference's golden CPU sort),
    including ``descending=True`` (stable reverse order).
    """
    from ..ops.sort import _order_mask, _to_radix_u32

    _validate(keys, sort_bits)
    mesh = mesh or make_sort_mesh()
    k, undo = _to_radix_u32(keys)
    if descending:
        k = k ^ _order_mask(sort_bits)
    out = _dist_sort_impl(k, None, sort_bits, mesh, use_ragged, None,
                          config=config)
    if descending:
        out = out ^ _order_mask(sort_bits)
    return undo(out)


@profiled("dist_sort_kv")
def dist_sort_kv(keys, values, sort_bits: int = 32, *,
                 descending: bool = False,
                 mesh: Mesh | None = None, config: Config | None = None,
                 use_ragged: bool = False):
    """Distributed stable key-value sort (values follow keys)."""
    from ..ops.sort import _order_mask, _to_radix_u32

    _validate(keys, sort_bits)
    if values.shape != keys.shape:
        raise ValueError("keys and values must have the same shape")
    mesh = mesh or make_sort_mesh()
    k, undo = _to_radix_u32(keys)
    if descending:
        k = k ^ _order_mask(sort_bits)
    ks, vs = _dist_sort_impl(k, values, sort_bits, mesh, use_ragged, None,
                             config=config)
    if descending:
        ks = ks ^ _order_mask(sort_bits)
    return undo(ks), vs
