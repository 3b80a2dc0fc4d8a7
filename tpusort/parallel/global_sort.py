"""Distributed multi-chip / multi-host global sort.

The reference is single-device (SURVEY.md §2.3); this supplies a global
sort across cards: keys range-partitioned via splitters, redistributed by
an all-to-all shuffle, locally sorted — globally sorted by construction.

Design decisions (static shapes, XLA collectives, which XLA hands to NCCL
on GPUs):

* **Exact splitters, not sampled.** Output shards must be STATIC-shape
  (N/D per device), so splitters are exact global order statistics,
  computed by a bitwise distributed selection: one count + ``psum`` round
  per key bit (32 per plane) — no data movement.  64-bit keys run the
  same selection over (hi, lo) planes with lexicographic prefix matching.
* **Skew-proof tie quotas.** Elements equal to a splitter are split across
  devices by their global tie rank (destination = (below + tie_rank) //
  shard), so even a single repeated value load-balances exactly — stronger
  than the reference's hot-bucket handling (cuda_radix_sort.h:437-447).
* **Chunked padded all-to-all.** Each device sends its bucket-d run padded
  to a fixed capacity C, split into ``chunks`` independent
  ``jax.lax.all_to_all`` pieces along the capacity axis; each piece
  depends only on its own slice of the send expansion, so XLA can overlap
  piece k's transfer with piece k+1's slicing.  Pair counts above C
  (pathologically pre-ordered inputs with small capacity)
  are detected and the sort falls back to an allgather + local sort via
  ``lax.cond``; with ``adaptive=True`` the overflow flag is also synced
  host-side and the geometry's capacity factor doubles for subsequent
  calls (the distributed analog of the single-chip host-owned
  ``on_overflow="flag"`` tier chain).
* **Engine-finished shards.** Both local sorts (before the shuffle, and
  after it on the compacted received runs) run the platform's registered
  default engine (``SortConfig.default_algorithm``), the same engine a
  single-card ``tpusort.sort`` would use.
* Validity is positional (slot s of a received run is garbage iff
  s >= count), the same convention as the single-chip MSD engine.

Scope: u32/i32/f32 single-plane dtypes and 2-plane 64-bit keys (via
``make_global_sort_planes``, or 64-bit dtypes where ``jax_enable_x64`` is
on); 32-bit payloads.  Pairs sort unstably across hosts (keys bit-exact;
pair equivalence is permutation-level, matching the reference's own
unstable-pair test semantics, test_sort_pairs.cu:81-113).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpusort import dtypes as _dtypes

__all__ = ["global_sort", "make_global_sort", "make_global_sort_planes"]


def _lex_lt_eq(plane_vals: Sequence[jax.Array], words: Sequence[jax.Array]):
    """Elementwise (v <lex w, v ==lex w) for multi-word values."""
    lt = None
    eq = None
    for a, s in zip(plane_vals, words):
        lt_i = a < s
        eq_i = a == s
        if lt is None:
            lt, eq = lt_i, eq_i
        else:
            lt = lt | (eq & lt_i)
            eq = eq & eq_i
    return lt, eq


def _select_splitters(
    planes: Sequence[jax.Array], n_shard: int, d: int, axis: str
):
    """Exact order statistics at ranks b*n_shard (b=1..D-1) of the global
    twiddled key multiset, plus the strictly-below counts.

    Bitwise radix selection, one plane at a time (most-significant first):
    within a plane, 32 rounds of count+psum refine all boundaries in
    parallel; finished planes constrain deeper rounds through an exact
    equality match mask.  Returns (splitter planes [(D-1,) uint32 ...],
    below (D-1,) uint32).

    Global counts (``below``, ``c0``, ``ranks``) are uint32: they range up
    to the GLOBAL n-1, which exceeds int32 beyond 2^31 total keys, and JAX
    holds no 64-bit arrays with ``jax_enable_x64`` off.  uint32 carries the
    reference's own single-device ceiling (2^32-1 keys,
    ``msb/src/sort/gpu_radix_sort.h:190`` ``IndexT = unsigned int``) to the
    distributed total.  ``ranks - below`` stays non-negative by
    construction (below only grows while staying <= rank), so the unsigned
    compare is exact.
    """
    nb = d - 1
    ranks = (jnp.arange(1, d, dtype=jnp.uint32)) * jnp.uint32(n_shard)
    n = planes[0].shape[0]
    below = jnp.zeros((nb,), jnp.uint32)
    match = jnp.ones((n, nb), bool)
    prefixes: List[jax.Array] = []
    for pw in planes:
        def round_(i, state, pw=pw, match=match):
            prefix, below = state
            bit = 31 - i
            cand0 = prefix << jnp.uint32(1)
            shifted = pw >> jnp.uint32(bit)
            local = (
                (shifted[:, None] == cand0[None, :]) & match
            ).sum(0, dtype=jnp.uint32)
            c0 = jax.lax.psum(local, axis)
            choose0 = (ranks - below) < c0
            prefix = jnp.where(choose0, cand0, cand0 + jnp.uint32(1))
            below = jnp.where(choose0, below, below + c0)
            return prefix, below

        prefix, below = jax.lax.fori_loop(
            0, 32, round_, (jnp.zeros((nb,), jnp.uint32), below)
        )
        prefixes.append(prefix)
        match = match & (pw[:, None] == prefix[None, :])
    return prefixes, below


def _destinations_sorted(
    planes_s: Sequence[jax.Array],
    splitters: Sequence[jax.Array],
    below: jax.Array,
    n_shard: int,
    d: int,
    axis: str,
):
    """Bucket starts/counts for a LOCALLY SORTED shard (exact tie quotas).

    Sorting first makes every tie run contiguous: rank-within-value is
    position minus run start (one cummax scan), destinations are monotone
    by construction, and the per-splitter comparisons are O(n * (d-1))
    vectorized lexicographic compares.  An element ties at most one
    splitter GROUP (equal splitters share a value; ``tie_idx = gt`` points
    at the group's first slot, and ``below + global tie rank`` spreads the
    group's value across its full span of shards).
    """
    nb = d - 1
    r = jax.lax.axis_index(axis)
    n = planes_s[0].shape[0]

    gt = jnp.zeros((n,), jnp.int32)   # #(splitter <lex v)
    ge = jnp.zeros((n,), jnp.int32)   # #(splitter <=lex v)
    eq_counts = []                    # per-splitter local tie counts
    for b in range(nb):
        words = [sp[b] for sp in splitters]
        s_lt_v, s_eq_v = _lex_lt_eq(
            [jnp.full((n,), w, jnp.uint32) for w in words],
            planes_s,
        )
        gt = gt + s_lt_v.astype(jnp.int32)
        ge = ge + (s_lt_v | s_eq_v).astype(jnp.int32)
        eq_counts.append(s_eq_v.sum(dtype=jnp.int32))
    is_tie = ge > gt
    tie_idx = jnp.clip(gt, 0, nb - 1)

    # local tie counts per splitter group (stored at the group's first slot)
    first_of_group = jnp.concatenate([
        jnp.ones((1,), bool),
        functools.reduce(
            jnp.logical_or,
            [sp[1:] != sp[:-1] for sp in splitters],
        ),
    ]) if len(splitters[0]) > 1 else jnp.ones((nb,), bool)
    t_local = jnp.where(first_of_group, jnp.stack(eq_counts), 0)
    t_all = jax.lax.all_gather(t_local, axis)                # (D, nb)
    # global tie counts below this shard sum across devices -> uint32 (the
    # global total can exceed int32; see _select_splitters)
    p_r = jnp.where(
        (jnp.arange(d) < r)[:, None], t_all, 0
    ).sum(0, dtype=jnp.uint32)                               # (nb,)

    idx = jnp.arange(n, dtype=jnp.int32)
    neq = functools.reduce(
        jnp.logical_or, [p_[1:] != p_[:-1] for p_ in planes_s]
    )
    neq = jnp.concatenate([jnp.ones((1,), bool), neq])
    run_start = jax.lax.cummax(jnp.where(neq, idx, 0))
    j = idx - run_start                                      # tie rank

    dest_tie = (
        (below[tie_idx] + p_r[tie_idx] + j.astype(jnp.uint32))
        // jnp.uint32(n_shard)
    ).astype(jnp.int32)
    dest = jnp.clip(jnp.where(is_tie, dest_tie, gt), 0, d - 1)
    starts = jnp.searchsorted(dest, jnp.arange(d), side="left").astype(
        jnp.int32
    )
    counts = jnp.concatenate(
        [starts[1:], jnp.asarray([n], jnp.int32)]
    ) - starts
    return starts, counts


def _local_engine_sort(planes, values, total_bits):
    """Full-range sort of one shard's twiddled planes by the platform's
    registered default engine."""
    from tpusort import api, configs

    cfg = configs.get_config(total_bits, bool(values))
    engine = api._resolve_engine("auto", cfg)
    return api._call_engine(
        engine, tuple(planes), tuple(values), begin_bit=0,
        end_bit=total_bits, total_bits=total_bits, config=cfg,
    )


def _global_sort_shard(
    ops: Sequence[jax.Array],
    nplanes: int,
    n_shard: int,
    d: int,
    axis: str,
    capacity: int,
    chunks: int,
    return_overflow: bool = False,
):
    """Per-shard body (runs under shard_map). ops = planes + values, u32."""
    from tpusort.ops.msd import compact_segments

    planes = list(ops[:nplanes])
    values = list(ops[nplanes:])
    splitters, below = _select_splitters(planes, n_shard, d, axis)

    # local sort BY KEY first, so splitter buckets are contiguous runs and
    # tie ranks are positional
    sp, sv = _local_engine_sort(planes, values, 32 * nplanes)
    planes_s = list(sp)
    sorted_ops = planes_s + list(sv)
    starts, counts = _destinations_sorted(
        planes_s, splitters, below, n_shard, d, axis
    )

    # padded-run expansion via d contiguous dynamic slices (plain copies),
    # CHUNKED along the capacity axis: piece j's all_to_all depends only on
    # piece j's slices, so transfers overlap the remaining slicing work
    # (SURVEY §7 step 5).  The capacity tail pad keeps every slice
    # in-bounds so runs stay at the front of their window (positional
    # validity on the receive side).
    cap_c = capacity // chunks
    padded = [
        jnp.concatenate([o, jnp.zeros((capacity,), o.dtype)])
        for o in sorted_ops
    ]

    def _expand_piece(opad, j):
        return jnp.stack([
            jax.lax.dynamic_slice_in_dim(
                opad, starts[b] + j * cap_c, cap_c
            )
            for b in range(d)
        ])

    recv_pieces: List[List[jax.Array]] = []
    for j in range(chunks):
        send_j = [_expand_piece(opad, j) for opad in padded]
        recv_pieces.append([
            jax.lax.all_to_all(s, axis, split_axis=0, concat_axis=0,
                               tiled=True)
            for s in send_j
        ])
    recv = [
        jnp.concatenate([rp[i] for rp in recv_pieces], axis=1)
        for i in range(len(sorted_ops))
    ]
    cmat = jax.lax.all_gather(counts, axis)                  # (D src, D dst)
    r = jax.lax.axis_index(axis)
    recv_counts = cmat[:, r]                                  # (D,)
    overflow = jax.lax.pmax(jnp.max(cmat), axis) > capacity

    def finish(_):
        # the finish lives INSIDE the cond so the overflow path does not
        # pay for the main pipeline's tail on top of the allgather
        # fallback (the shuffle above already happened; only its bytes are
        # sunk).  ``overflow`` is pmax-uniform across the axis, so branch
        # divergence cannot deadlock the fallback's all_gather.
        #
        # The received layout — d runs of ``capacity`` with valid prefix
        # lengths — is compacted in order (each shard receives exactly
        # n_shard valid elements by splitter construction), then sorted.
        seg_counts = jnp.minimum(recv_counts, jnp.int32(capacity))
        compacted = compact_segments(
            [x.reshape(-1) for x in recv], seg_counts, capacity, n_shard
        )
        sp2, sv2 = _local_engine_sort(
            compacted[:nplanes], compacted[nplanes:], 32 * nplanes
        )
        return list(sp2) + list(sv2)

    def fallback(_):
        # allgather everything, sort locally, take the owned range
        full = [jax.lax.all_gather(o, axis).reshape(-1) for o in ops]
        srt = jax.lax.sort(full, num_keys=nplanes)
        return [
            jax.lax.dynamic_slice_in_dim(x, r * n_shard, n_shard)
            for x in srt
        ]

    out = jax.lax.cond(overflow, fallback, finish, None)
    if return_overflow:
        # pmax above makes the flag axis-uniform, so it satisfies a
        # replicated out_spec (the adaptive tier syncs it host-side)
        return out + [overflow]
    return out


def _make_sharded_body(mesh, axis_name, nplanes, n_values, n_shard, d,
                       capacity, chunks, return_overflow=False):
    spec = P(axis_name)
    body = functools.partial(
        _global_sort_shard,
        nplanes=nplanes,
        n_shard=n_shard,
        d=d,
        axis=axis_name,
        capacity=capacity,
        chunks=chunks,
        return_overflow=return_overflow,
    )
    n_ops = nplanes + n_values
    out_specs = tuple(spec for _ in range(n_ops))
    if return_overflow:
        out_specs = out_specs + (P(),)
    return jax.jit(
        jax.shard_map(
            lambda *o: tuple(body(o)),
            mesh=mesh,
            in_specs=tuple(spec for _ in range(n_ops)),
            out_specs=out_specs,
            check_vma=False,
        )
    )


def _capacity_for(n_shard: int, d: int, capacity_factor: float,
                  chunks: int) -> int:
    cap = min(
        n_shard,
        int(capacity_factor * max(n_shard // d, 1) + 127) // 128 * 128,
    )
    # the chunked exchange slices the capacity axis evenly
    q = 128 * chunks
    cap = max(q, (cap + q - 1) // q * q)
    return cap
def make_global_sort(
    mesh: Mesh,
    *,
    axis_name: Optional[str] = None,
    capacity_factor: float = 4.0,
    chunks: int = 1,
    adaptive: bool = False,
):
    """Build a jitted distributed sorter over a 1-D mesh axis.

    Returns fn(keys[, values]) operating on arrays sharded (or shardable)
    along the axis; output is the globally sorted array with the same
    sharding.  ``chunks`` splits the all-to-all into that many independent
    pieces along the capacity axis (overlappable transfers).

    ``adaptive=True`` is the host-owned capacity tier (the distributed
    analog of the single-chip ``on_overflow="flag"`` chain): after each
    call the overflow flag is synced to the host, and a geometry that
    overflowed doubles its ``capacity_factor`` for SUBSEQUENT calls
    (recompiling once) until the capacity saturates at n/D, where
    overflow is impossible.  The overflowed call itself is still exact
    (in-graph allgather fallback) — adaptation removes the fallback from
    steady-state repeated calls, at the price of one host sync per call.
    Leave off inside fully-pipelined training steps.
    """
    if axis_name is None:
        axis_name = mesh.axis_names[0]
    d = mesh.shape[axis_name]
    shard_fns = {}   # geometry -> jitted shard body (persist across calls)
    factors = {}     # base geometry -> adapted capacity_factor

    def sorter(keys, values=None, *, descending: bool = False):
        n = keys.shape[0]
        if n % d:
            raise ValueError(f"n={n} must be divisible by mesh size {d}")
        if d == 1:
            # single device: the whole distributed machinery degenerates —
            # go straight to the local engine
            from tpusort.api import sort as _local_sort

            return _local_sort(keys, values, descending=descending,
                               stable=False)
        n_shard = n // d
        planes, traits = _dtypes.twiddle_in(keys, descending=descending)
        vt = (
            ()
            if values is None
            else ((values,) if not isinstance(values, (tuple, list))
                  else tuple(values))
        )
        vops = [jnp.asarray(v).view(jnp.uint32) for v in vt]
        ops = list(planes) + vops

        base = (len(planes), len(vops), n_shard)
        factor = factors.get(base, capacity_factor)
        capacity = _capacity_for(n_shard, d, factor, chunks)
        geom = base + (capacity,)
        shard_fn = shard_fns.get(geom)
        if shard_fn is None:
            # build the jitted shard body once per geometry: a fresh
            # wrapper per call would miss the jit cache and re-trace the
            # whole distributed program every sort
            shard_fn = shard_fns[geom] = _make_sharded_body(
                mesh, axis_name, len(planes), len(vops), n_shard, d,
                capacity, chunks, return_overflow=adaptive,
            )
        out = shard_fn(*ops)
        if adaptive:
            out, ovf = list(out[:-1]), out[-1]
            if capacity < n_shard and bool(np.asarray(ovf)):
                factors[base] = factor * 2.0
        out_planes = tuple(out[: len(planes)])
        out_keys = _dtypes.twiddle_out(
            out_planes, traits, descending=descending, dtype=keys.dtype
        )
        out_vals = tuple(
            o.view(jnp.asarray(v).dtype) for o, v in zip(out[len(planes):], vt)
        )
        if values is None:
            return out_keys
        if isinstance(values, (tuple, list)):
            return out_keys, out_vals
        return out_keys, out_vals[0]

    sorter._factors = factors      # introspection (tests/adaptive tier)
    sorter._shard_fns = shard_fns
    return sorter


def make_global_sort_planes(
    mesh: Mesh,
    *,
    key_dtype: str = "uint64",
    axis_name: Optional[str] = None,
    capacity_factor: float = 4.0,
    chunks: int = 1,
    adaptive: bool = False,
):
    """Distributed sorter for keys supplied as raw uint32 bit-pattern
    planes (plane 0 = most-significant word) — the 64-bit interface for
    callers with ``jax_enable_x64`` off (see ``tpusort.sort_planes``).

    Returns fn(planes[, values]) -> sorted planes (and values).
    ``adaptive`` as in :func:`make_global_sort`."""
    if axis_name is None:
        axis_name = mesh.axis_names[0]
    d = mesh.shape[axis_name]
    traits = _dtypes.traits_for(key_dtype)
    shard_fns = {}   # geometry -> jitted shard body (persist across calls)
    factors = {}     # base geometry -> adapted capacity_factor

    def sorter(planes, values=None, *, descending: bool = False):
        planes = tuple(jnp.asarray(p).view(jnp.uint32) for p in planes)
        if len(planes) != traits.planes:
            raise ValueError(
                f"{key_dtype} expects {traits.planes} planes, got "
                f"{len(planes)}"
            )
        n = planes[0].shape[0]
        if n % d:
            raise ValueError(f"n={n} must be divisible by mesh size {d}")
        if d == 1:
            # single device: degenerate (same guard as make_global_sort —
            # with nb = d-1 = 0 the tie-rank gather would index an empty
            # below[] array)
            from tpusort.api import sort_planes as _local_sort_planes

            return _local_sort_planes(
                planes, values, key_dtype=key_dtype, descending=descending,
                stable=False,
            )
        n_shard = n // d
        tw = _dtypes.twiddle_planes_in(planes, traits, descending=descending)
        vt = (
            ()
            if values is None
            else ((values,) if not isinstance(values, (tuple, list))
                  else tuple(values))
        )
        vops = [jnp.asarray(v).view(jnp.uint32) for v in vt]
        ops = list(tw) + vops
        base = (len(tw), len(vops), n_shard)
        factor = factors.get(base, capacity_factor)
        capacity = _capacity_for(n_shard, d, factor, chunks)
        geom = base + (capacity,)
        shard_fn = shard_fns.get(geom)
        if shard_fn is None:
            shard_fn = shard_fns[geom] = _make_sharded_body(
                mesh, axis_name, len(tw), len(vops), n_shard, d, capacity,
                chunks, return_overflow=adaptive,
            )
        out = shard_fn(*ops)
        if adaptive:
            out, ovf = list(out[:-1]), out[-1]
            if capacity < n_shard and bool(np.asarray(ovf)):
                factors[base] = factor * 2.0
        out_planes = tuple(
            _dtypes.twiddle_planes_out(
                tuple(out[: len(tw)]), traits, descending=descending
            )
        )
        out_vals = tuple(
            o.view(jnp.asarray(v).dtype) for o, v in zip(out[len(tw):], vt)
        )
        if values is None:
            return out_planes
        if isinstance(values, (tuple, list)):
            return out_planes, out_vals
        return out_planes, out_vals[0]

    sorter._factors = factors      # introspection (tests/adaptive tier)
    sorter._shard_fns = shard_fns
    return sorter


def global_sort(
    keys,
    values=None,
    *,
    mesh: Optional[Mesh] = None,
    descending: bool = False,
    capacity_factor: float = 4.0,
    chunks: int = 1,
):
    """One-shot distributed global sort over all devices (1-D mesh)."""
    if mesh is None:
        mesh = jax.make_mesh((len(jax.devices()),), ("x",))
    sorter = make_global_sort(mesh, capacity_factor=capacity_factor,
                              chunks=chunks)
    return sorter(keys, values, descending=descending)
