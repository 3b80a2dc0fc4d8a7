"""MSD hybrid radix sort engine ("msd").

A static-shape formulation of the reference's MSB hierarchical radix sort
(``msb/src/sort/gpu_radix_sort.h:197-507`` orchestrator;
``cuda_radix_sort.h:374-641`` partition kernels; ``:1342-1620`` local/leaf
sorts), written in plain ``jax.numpy``/``lax`` and left to XLA.  Where the
reference reserves bucket ranges with atomics, plans on the CPU between
passes and feeds dynamic bucket->block work queues, this engine is fully
static:

* **partition pass**: tiles are sorted by (digit, idx) [a stable local
  digit-binning, one batched ``lax.sort`` over the tile rows], each tile's
  R digit runs are emitted PADDED to a static capacity S, laid out
  (T, R, S); the global exchange is then a transpose to digit-major
  (R, T, S).  Padding replaces the reference's atomic offset reservations
  AND its CPU block planner: bucket-size variance is absorbed by slack
  instead of dynamic work assignment.
* **validity is positional, never stored**: a pad slot (d, s) of a tile is
  garbage iff s >= c(t, d); each pass derives a validity mask from the
  previous pass's (tiny) counts table.  No payload bits are spent.
* **leaf pass**: after p passes the (d1..dp) buckets are contiguous padded
  segments, each sorted over the remaining key bits (packed with a
  stability index into a single uint32 sortkey when they fit) — the analog
  of ``do_locrec_radix_sort_keys`` finishing small buckets in one thread
  block.
* **skew**: a run overflowing its capacity (c > S) is detected from the
  counts (the analog of the reference's hot-bucket look-ahead trigger,
  ``cuda_radix_sort.h:437-447``); the engine then falls back to the stable
  XLA sort via lax.cond, so correctness never depends on the distribution.
* one final order-preserving compaction drops the pad slots.

Unlike the reference's MSB sort this engine is STABLE (tile sorts tiebreak
on position, runs concatenate in tile order), so it can serve as the LSB
engine's semantics too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from tpusort.ops.reference import sort_twiddled_reference
from tpusort.utils.device import cond_fallback_fits

# ---------------------------------------------------------------------------
# Geometry planning
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PassSpec:
    n_seg: int       # independent segments this pass operates within
    t_seg: int       # tiles per segment
    k: int           # tile size (elements)
    r: int           # radix (runs per tile)
    s: int           # padded run capacity (elements, multiple of 128)
    lo_bit: int      # LSB position of this pass's digit
    width: int       # digit width in bits (<= log2(r))


@dataclass(frozen=True)
class MsdPlan:
    m1: int                      # padded element count entering pass 1
    passes: Tuple[PassSpec, ...]
    seg: int                     # final segment size (elements)
    n_segments: int
    m_final: int
    rem_lo: int                  # leaf sorts bits [rem_lo, rem_lo + rem_width)
    rem_width: int


def plan_msd(
    n: int,
    begin_bit: int,
    end_bit: int,
    *,
    k: int = 1 << 14,
    r: int = 32,
    s1: Optional[int] = None,
    s: Optional[int] = None,
    leaf_max: Optional[int] = None,
) -> Optional[MsdPlan]:
    """Compute a static pass plan, or None if no feasible plan exists.

    Geometry invariants (all checked):
      * every pass's tiles hold exactly K elements and emit R runs of S;
      * pass outputs regroup into next-pass tiles without straddling digit
        segments (T_seg multiple of K/S_prev runs-per-tile, segments multiples
        of K);
      * the final segments are <= leaf_max and multiples of 128.

    The cost model keys the leaf on its remaining bit width (the
    ``GetSortKernel`` analog, ``msb/src/sort/gpu_sort_config.h:250-264``):
    the leaf packs (rem, idx) into one sortkey word and falls to the
    multikey sort when ``rem_width + idx_bits + 1 > 32`` — so near that
    boundary the search trades an extra partition pass against the slow
    leaf.
    """
    import math

    log_r = r.bit_length() - 1
    if s1 is None:
        s1 = ((3 * k // (2 * r)) // 128) * 128      # alpha ~ 1.5 on pass 1
    if s is None:
        s = k // r                                  # alpha-preserving after
    if leaf_max is None:
        # a bigger leaf saves a whole partition pass at awkward sizes
        leaf_max = max(2 * k, 1 << 15)
    if k % (r * 128) or s % 128 or s1 % 128:
        return None

    bits = end_bit - begin_bit

    def _cap_ok(kp: int, cap: int, density: float) -> bool:
        """Run capacity must clear the binomial mean by ~6.5 sigma, or
        uniform inputs would routinely trip the overflow fallback."""
        mean = kp * density / r
        sigma = math.sqrt(max(mean * (1 - 1 / r), 1.0))
        return cap >= mean + 6.5 * sigma

    def _try(p: int, t1: int) -> Optional[MsdPlan]:
        """Build a p-pass plan with T1 tiles, or None if infeasible."""
        density = (k / r) / s1          # valid fraction after pass 0
        if not _cap_ok(k, s1, 1.0):
            return None
        seg = t1 * s1
        specs = [PassSpec(1, t1, k, r, s1, end_bit - min(log_r, bits),
                          min(log_r, bits))]
        n_seg = r
        for _ in range(1, p):
            # segments must be whole numbers of tiles (tiles may not span
            # two digit segments — that would interleave order boundaries).
            # When the default tile size doesn't divide the segment, shrink
            # this pass's tile (e.g. 2^29: seg3 = 24576 = 3 * 8192).
            kp = k
            while kp >= r * 128 and seg % kp:
                kp //= 2
            if kp < r * 128 or seg % kp:
                return None
            sp_ = kp // r if s == k // r else s
            if sp_ % 128 or sp_ > kp:
                return None
            if not _cap_ok(kp, sp_, density):
                return None
            t_seg = seg // kp
            consumed = sum(q.width for q in specs)
            width = min(log_r, bits - consumed)
            if width <= 0:
                return None
            lo = end_bit - consumed - width
            specs.append(PassSpec(n_seg, t_seg, kp, r, sp_, lo, width))
            seg = t_seg * sp_
            n_seg *= r
        if seg > leaf_max or seg % 128:
            return None
        consumed = sum(sp.width for sp in specs)
        return MsdPlan(
            m1=t1 * k,
            passes=tuple(specs),
            seg=seg,
            n_segments=n_seg,
            m_final=n_seg * seg,
            rem_lo=begin_bit,
            rem_width=bits - consumed,
        )

    # Relative per-pass and leaf overheads (emit, exchange and compaction
    # writes), in sort-stage equivalents per element.  Not calibrated on
    # the GPU: they only rank plans against each other.
    _OH_PASS = 18.0
    _OH_LEAF = 20.0

    def _leaf_slots(seg: int, run: int) -> float:
        """Stage-slots (stages x elements) of a merge network over one
        pow2-padded ``seg``-element row with sorted ``run``-subruns."""
        c = run.bit_length() - 1
        pow2 = 1 << (seg - 1).bit_length()
        return float(sum(range(c + 1, pow2.bit_length())) * pow2)

    def _cost(plan: MsdPlan) -> float:
        """Stage-slot cost model (sort stages x elements + per-pass
        overheads, with penalties for tiny t_seg)."""
        total = 0.0
        prev_s = None
        for sp in plan.passes:
            nb_pen = 1.0 if sp.t_seg % 4 == 0 else 1.35
            lgk = sp.k.bit_length() - 1
            if prev_s is None:
                stages = lgk * (lgk + 1) / 2          # full sort
            else:
                k0 = (prev_s & -prev_s).bit_length() - 1
                stages = sum(range(k0 + 1, lgk + 1))  # merge tail
            total += (stages * nb_pen + _OH_PASS) * sp.n_seg * sp.t_seg * sp.k
            prev_s = sp.s
        # leaf: merge from the last pass's pow2 run size; the packed
        # sortkey needs rem + idx (+ tie headroom) to fit one u32 word,
        # past that the leaf drops to the multikey sort
        run = prev_s & -prev_s
        idx_bits = (plan.seg - 1).bit_length()
        if plan.seg >= (1 << idx_bits):
            idx_bits += 1
        leaf_mult = 5.0 if plan.rem_width + idx_bits + 1 > 32 else 1.15
        total += plan.n_segments * (
            _leaf_slots(plan.seg, run) * leaf_mult + _OH_LEAF * plan.seg
        )
        return total

    best = None
    for p in range(1, 5):
        if bits < log_r * p:
            break
        quantum = k // math.gcd(s1, k)
        tiles_needed = -(-n // k)
        t1_base = -(-tiles_needed // quantum) * quantum
        for step in range(512):
            t1 = t1_base + step * quantum
            if t1 * k > max(8 * n, 1 << 23):
                break
            plan = _try(p, t1)
            if plan is not None:
                c = _cost(plan)
                if best is None or c < best[0]:
                    best = (c, plan)
        # keep searching other pass counts and t1 values: more passes or
        # more padding can beat a shallower plan with tiny t_seg
    return None if best is None else best[1]


# ---------------------------------------------------------------------------
# Bit-plane helpers
# ---------------------------------------------------------------------------


def _extract_bits(planes: Sequence[jax.Array], lo: int, width: int) -> jax.Array:
    """Bits [lo, lo+width) of the multi-plane key, as uint32 (width <= 32).

    Plane 0 is the most-significant 32 bits.
    """
    nplanes = len(planes)
    out = None
    for i, pl_ in enumerate(planes):
        base = 32 * (nplanes - 1 - i)
        ov_lo = max(lo, base)
        ov_hi = min(lo + width, base + 32)
        if ov_hi <= ov_lo:
            continue
        mask = jnp.uint32((1 << (ov_hi - ov_lo)) - 1)
        chunk = (pl_ >> jnp.uint32(ov_lo - base)) & mask
        chunk = chunk << jnp.uint32(ov_lo - lo)
        out = chunk if out is None else out | chunk
    if out is None:
        return jnp.zeros_like(planes[0])
    return out


# ---------------------------------------------------------------------------
# Pass building blocks
# ---------------------------------------------------------------------------


def _sort_tiles(ops: List[jax.Array]) -> List[jax.Array]:
    """Sort rows of each (T, K) operand ascending by ops[0] (all uint32)."""
    return list(jax.lax.sort(ops, dimension=1, num_keys=1, is_stable=False))


def _expand(
    sorted_ops: List[jax.Array], starts: jax.Array, r: int, s: int
) -> List[jax.Array]:
    """Monotonic padded expand: (T, K) sorted tiles -> (T, R*S) padded runs.

    out[t, d*S + j] = sorted[t, starts[t, d] + j]   (clamped; slots beyond a
    run's count are positionally-invalid garbage and never consulted).
    """
    T, K = sorted_ops[0].shape
    offs = jnp.arange(s, dtype=jnp.int32)
    idx = starts[:, :, None].astype(jnp.int32) + offs[None, None, :]  # (T,R,S)
    idx = jnp.minimum(idx.reshape(T, r * s), K - 1)
    return [jnp.take_along_axis(o, idx, axis=1) for o in sorted_ops]


def _valid_mask(run_counts: jax.Array, s_prev: int, t: int, k: int) -> jax.Array:
    """(T, K) bool validity from the previous pass's run counts.

    Element at GLOBAL flat position p is valid iff (p mod S_prev) <
    counts[p div S_prev].  Runs may straddle tile boundaries (stability is
    unaffected: a straddled run's head and tail tiles emit in tile order);
    only segment boundaries must align with tiles, which the plan checks.
    """
    num_runs = (t * k) // s_prev
    c = run_counts.reshape(num_runs, 1)
    pos = jnp.arange(s_prev, dtype=jnp.int32)
    return (pos[None, :] < c).reshape(t, k)


def _histogram(digit: jax.Array, valid: jax.Array, r: int) -> jax.Array:
    """(T, R) counts of valid digits (one-hot sum)."""
    oh = (digit[:, :, None] == jnp.arange(r, dtype=jnp.uint32)) & valid[:, :, None]
    return oh.sum(axis=1, dtype=jnp.int32)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _partition_pass(
    ops: List[jax.Array],
    planes_slice: slice,
    run_counts: jax.Array,
    s_prev: int,
    spec: PassSpec,
) -> Tuple[List[jax.Array], jax.Array, jax.Array]:
    """One MSD partition pass over flat operands.

    ops: flat (M,) uint32 arrays: [plane0, plane1?, values...].
    Returns (new_ops, new_run_counts, overflow_flag).
    """
    t = spec.n_seg * spec.t_seg
    k, r, s = spec.k, spec.r, spec.s
    tiled = [o.reshape(t, k) for o in ops]
    planes = tiled[planes_slice]

    digit = _extract_bits(planes, spec.lo_bit, spec.width).reshape(t, k)
    valid = _valid_mask(run_counts, s_prev, t, k)

    counts = _histogram(digit, valid, r)                       # (T, R)
    overflow = jnp.any(counts > s)
    starts = jnp.cumsum(counts, axis=1) - counts               # exclusive

    idx_bits = k.bit_length() - 1
    idx = jnp.arange(k, dtype=jnp.uint32)[None, :]
    sentinel = jnp.uint32(r)
    d_or_s = jnp.where(valid, digit, sentinel)
    sortkey = (d_or_s << jnp.uint32(idx_bits)) | idx

    sorted_ops = _sort_tiles([sortkey] + tiled)[1:]
    out_tiles = _expand(sorted_ops, starts, r, s)              # (T, R*S)

    # global exchange: digit-major within each segment (a transpose)
    out = []
    for o in out_tiles:
        o4 = o.reshape(spec.n_seg, spec.t_seg, r, s)
        out.append(o4.transpose(0, 2, 1, 3).reshape(-1))
    cT = counts.reshape(spec.n_seg, spec.t_seg, r).transpose(0, 2, 1)
    new_counts = jnp.minimum(cT.reshape(-1), s)
    return out, new_counts, overflow


def _leaf_sort(
    ops: List[jax.Array],
    planes_slice: slice,
    valid: jax.Array,
    plan: MsdPlan,
) -> Tuple[List[jax.Array], jax.Array]:
    """Sort each final segment by the remaining key bits, stably.

    ``valid``: (nseg, seg) bool validity.  Returns (ops sorted within
    segments: valid prefix per segment, followed by garbage; per-segment
    valid counts).
    """
    nseg, seg = plan.n_segments, plan.seg
    tiled = [o.reshape(nseg, seg) for o in ops]
    planes = tiled[planes_slice]
    nplanes = planes_slice.stop - (planes_slice.start or 0)

    seg_counts = valid.sum(axis=1, dtype=jnp.int32)

    # idx field must have headroom above seg-1 so the per-segment garbage
    # sentinel (all-ones rem, all-ones idx) sorts strictly after every valid
    # element of its segment
    idx_bits = (seg - 1).bit_length()
    if seg >= (1 << idx_bits):
        idx_bits += 1
    idx = jnp.arange(seg, dtype=jnp.uint32)[None, :]
    rem = _extract_bits(planes, plan.rem_lo, plan.rem_width).reshape(nseg, seg)

    # keys are reconstructible from (segment prefix | rem) — so the key
    # plane need not be carried through the leaf sort — when the partitions
    # + remainder cover the full single-plane key and every pass used its
    # full digit width (then segment linear index == bit prefix)
    consumed = sum(sp.width for sp in plan.passes)
    full_width = all(
        sp.width == sp.r.bit_length() - 1 for sp in plan.passes
    )
    key_from_sortkey = (
        nplanes == 1
        and plan.rem_lo == 0
        and consumed + plan.rem_width == 32
        and full_width
    )

    if plan.rem_width + idx_bits + 1 <= 32:
        # pack several segments per sorted row (segid high bits keep each
        # segment's garbage at its own end): fewer, longer rows
        max_tile = 16384
        pack = 1
        while (
            pack * 2 * seg <= max_tile
            and nseg % (pack * 2) == 0
            and (pack * 2 - 1).bit_length() + plan.rem_width + idx_bits <= 32
        ):
            pack *= 2
        segid_bits = (pack - 1).bit_length()
        shift_rem = jnp.uint32(idx_bits)
        sortkey = jnp.where(
            valid,
            (rem << shift_rem) | idx,
            jnp.uint32(((1 << (plan.rem_width + idx_bits)) - 1)),
        )
        if segid_bits:
            segid = (
                jnp.arange(nseg, dtype=jnp.uint32)[:, None] % pack
            ) << jnp.uint32(plan.rem_width + idx_bits)
            sortkey = sortkey | segid
        carried = tiled[1:] if key_from_sortkey else tiled
        to_sort = [sortkey.reshape(nseg // pack, pack * seg)] + [
            o.reshape(nseg // pack, pack * seg) for o in carried
        ]
        sorted_all = _sort_tiles(to_sort)
        sorted_key = sorted_all[0].reshape(nseg, seg)
        sorted_ops = [o.reshape(nseg, seg) for o in sorted_all[1:]]
        if key_from_sortkey:
            # rebuild the key plane: segment prefix | rem
            prefix = jnp.arange(nseg, dtype=jnp.uint32)[:, None]
            rem_sorted = (sorted_key >> shift_rem) & jnp.uint32(
                (1 << plan.rem_width) - 1
            )
            rebuilt = (prefix << jnp.uint32(plan.rem_width)) | rem_sorted
            sorted_ops = [rebuilt] + sorted_ops
    else:
        # wide remainder (64-bit keys / few passes): multi-key stable sort on
        # the range-masked planes, with the position index as tiebreak.
        from tpusort.ops.reference import _mask_plane_bits

        masked = _mask_plane_bits(
            tuple(planes), plan.rem_lo, plan.rem_lo + plan.rem_width,
            32 * len(planes),
        )
        keys = [jnp.where(valid, mp, jnp.uint32(0xFFFFFFFF)) for mp in masked]
        keys.append(jnp.where(valid, idx, jnp.uint32(0xFFFFFFFF)))
        sorted_ops = list(
            jax.lax.sort(
                keys + tiled, dimension=1, num_keys=len(keys),
                is_stable=False
            )
        )[len(keys):]
    return [o.reshape(-1) for o in sorted_ops], seg_counts


def compact_segments(
    ops: List[jax.Array], seg_counts: jax.Array, seg: int, n: int
) -> List[jax.Array]:
    """Order-preserving drop of per-segment garbage tails.

    ``ops`` are flat arrays of ``len(seg_counts)`` segments of ``seg``
    elements; segment i holds ``seg_counts[i]`` valid elements as a prefix.
    Returns the first ``n`` elements of the concatenated valid prefixes
    (``n`` may be below the count sum; above it the tail is undefined).
    """
    offsets = jnp.cumsum(seg_counts) - seg_counts            # (nseg,)
    j = jnp.arange(n, dtype=jnp.int32)
    segid = jnp.searchsorted(offsets, j, side="right") - 1
    # (row, column) indexing: the flat source index can pass int32
    col = j - offsets[segid]
    return [o.reshape(-1, seg)[segid, col] for o in ops]


def _run_passes(
    ops: List[jax.Array], planes_slice: slice, n: int, plan: MsdPlan
) -> Tuple[List[jax.Array], jax.Array, jax.Array]:
    """All partition passes (counts-derived validity).
    Returns (ops, final validity as (m,) bool, overflow)."""
    k0 = plan.passes[0].k
    t0 = plan.m1 // k0
    run_counts = jnp.clip(
        n - jnp.arange(t0, dtype=jnp.int32) * k0, 0, k0
    )
    s_prev = k0
    overflow = jnp.asarray(False)
    for spec in plan.passes:
        ops, run_counts, ovf = _partition_pass(
            ops, planes_slice, run_counts, s_prev, spec
        )
        overflow |= ovf
        s_prev = spec.s
    valid = _valid_mask(run_counts, s_prev, plan.n_segments, plan.seg)
    return ops, valid.reshape(-1), overflow


def sort_twiddled_msd(
    planes: Tuple[jax.Array, ...],
    values: Sequence[jax.Array],
    *,
    begin_bit: int,
    end_bit: int,
    total_bits: int,
    plan_kwargs: Optional[dict] = None,
    on_overflow: str = "cond",
    config=None,
):
    """MSD hybrid engine entry (engine-registry signature).

    Stable.  Delegates to the reference sort when no feasible plan exists
    (small n, narrow bit ranges, non-32-bit payloads) or — via lax.cond —
    when run overflow reveals a skewed distribution the static padding
    cannot absorb.

    ``on_overflow="flag"``: skip the in-graph ``lax.cond`` fallback and
    return ``(planes, values, overflow)`` instead — the caller owns the
    fallback decision (host-side re-sort, error, retry).  This removes
    the fallback branch's workspace RESERVATION, so flag mode runs sizes
    whose in-graph fallback would not fit the device
    (:func:`tpusort.utils.device.cond_fallback_fits`).
    """
    flag_mode = on_overflow == "flag"
    n = planes[0].shape[0]
    if plan_kwargs is None and config is not None:
        # the registered tuning config steers the planner (the reference's
        # RadixSortConfig TPB/KPT analog, gpu_sort_config.h:146-207)
        plan_kwargs = config.plan_kwargs()
    kwargs = dict(plan_kwargs or {})
    min_n = kwargs.pop("min_n", 1 << 16)
    plan = None
    # non-32-bit payloads delegate (the API splits 64-bit operands first)
    if n >= min_n and all(jnp.dtype(v.dtype).itemsize == 4 for v in values):
        plan = plan_msd(n, begin_bit, end_bit, **kwargs)
    if plan is not None and not flag_mode and not cond_fallback_fits(
            n, len(planes) + len(values)):
        # the cond fallback branch would reserve the reference sort's
        # workspace on top of the pipeline's live set; in-graph callers get
        # the reference path, flag-mode callers the full pipeline
        plan = None
    if plan is None:
        sp, sv = sort_twiddled_reference(
            planes, values, begin_bit=begin_bit, end_bit=end_bit,
            total_bits=total_bits,
        )
        return (sp, sv, jnp.asarray(False)) if flag_mode else (sp, sv)

    nplanes = len(planes)
    ops = [jnp.pad(p, (0, plan.m1 - n)) for p in planes]
    ops += [jnp.pad(jnp.asarray(v).view(jnp.uint32), (0, plan.m1 - n))
            for v in values]
    planes_slice = slice(0, nplanes)

    ops, valid, overflow = _run_passes(ops, planes_slice, n, plan)
    ops, seg_counts = _leaf_sort(
        ops, planes_slice, valid.reshape(plan.n_segments, plan.seg), plan,
    )
    ops = compact_segments(ops, seg_counts, plan.seg, n)

    def _fallback(_):
        sp, sv = sort_twiddled_reference(
            planes, values, begin_bit=begin_bit, end_bit=end_bit,
            total_bits=total_bits,
        )
        return list(sp) + [jnp.asarray(v).view(jnp.uint32) for v in sv]

    def _ok(_):
        return ops

    if not flag_mode:
        ops = jax.lax.cond(overflow, _fallback, _ok, None)

    out_planes = tuple(ops[:nplanes])
    out_values = tuple(
        o.view(jnp.asarray(v).dtype) for o, v in zip(ops[nplanes:], values)
    )
    if flag_mode:
        return out_planes, out_values, overflow
    return out_planes, out_values
