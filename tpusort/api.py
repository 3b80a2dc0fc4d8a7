"""Public sort API.

The reference's two public surfaces, re-designed for JAX:

* ``cub::DeviceRadixSort::{SortKeys, SortPairs, *Descending}`` with
  ``begin_bit``/``end_bit`` sub-range sorts
  (``lsb/cub/cub/device/device_radix_sort.cuh:147-660``), and
* the MSB entry points ``rdxsrt_unstable_sort{,_keys,_pairs}``
  (``msb/src/sort/gpu_radix_sort.h:197-587``).

Differences by design (JAX idiom, not translation):

* No two-call temp-storage protocol and no ``DoubleBuffer`` — XLA owns
  allocation and buffer ping-ponging; every function is functional and
  jit-able.
* 64-bit keys are decomposed into uint32 planes at the boundary
  (see :mod:`tpusort.dtypes`), so every engine sorts uint32 operands.
* Engine selection is a runtime registry (analog of the reference's
  kernel-config registries, ``msb/src/sort/gpu_sort_config.h:267-336``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from tpusort import configs as _configs
from tpusort import dtypes as _dtypes
from tpusort.ops.reference import sort_twiddled_reference
from tpusort.utils.device import cond_fallback_fits

__all__ = [
    "sort",
    "argsort",
    "sort_keys",
    "sort_keys_descending",
    "sort_pairs",
    "sort_pairs_descending",
    "sort_planes",
    "unstable_sort_keys",
    "unstable_sort_pairs",
    "sort_pairs_lsb_in_value",
    "register_engine",
    "available_engines",
]


# ---------------------------------------------------------------------------
# Engine registry
# ---------------------------------------------------------------------------

# An engine sorts twiddled uint32 plane(s) + payload arrays ascending:
#   engine(planes, values, begin_bit, end_bit, total_bits, config)
#     -> (sorted_planes, sorted_values)
Engine = Callable[..., Tuple[Tuple[jax.Array, ...], Tuple[jax.Array, ...]]]

_ENGINES: Dict[str, Engine] = {}


def register_engine(name: str, fn: Engine) -> None:
    _ENGINES[name] = fn


def _call_engine(engine: Engine, planes, values_tuple, **kw):
    """Invoke an engine, passing ``config=`` only if its signature takes it
    (user engines registered against the documented Engine contract predate
    the config kwarg and must keep working)."""
    import inspect

    try:
        params = inspect.signature(engine).parameters
        takes_config = "config" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
        )
    except (TypeError, ValueError):
        takes_config = False
    if not takes_config:
        kw.pop("config", None)
    return engine(planes, values_tuple, **kw)


def available_engines() -> Tuple[str, ...]:
    return tuple(sorted(_ENGINES))


register_engine("reference", sort_twiddled_reference)
# "xla" is the production alias of the masked-plane stable variadic sort:
# XLA's own sort (CUB's radix sort on the GPU where the operand shape
# allows) and the correctness fallback for pathological inputs.
register_engine("xla", sort_twiddled_reference)


def _register_builtin_engines():
    from tpusort.ops.msd import sort_twiddled_msd
    from tpusort.ops.small import sort_twiddled_bitonic

    register_engine("msd", sort_twiddled_msd)
    # the reference's rdxsrt_unstable_sort_pairs name
    # (msb/src/sort/gpu_radix_sort.h:544-587); the engine is stable, which
    # satisfies the unstable contract
    register_engine("msd_unstable", sort_twiddled_msd)
    # The MSD hybrid here is stable (position-index tiebreaks throughout),
    # so it provides the reference's LSB/stable semantics too; "lsd" is the
    # CUB-parity name (device_radix_sort.cuh:147-660).
    register_engine("lsd", sort_twiddled_msd)
    # single-tile small-N fast path (InvokeSingleTile / sorting-network
    # analog); unstable
    register_engine("bitonic", sort_twiddled_bitonic)


_register_builtin_engines()


def _resolve_engine(algorithm: str, config: _configs.SortConfig) -> Engine:
    if algorithm == "auto":
        algorithm = config.default_algorithm
        if algorithm not in _ENGINES:
            algorithm = "reference"
    if algorithm not in _ENGINES:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; available: {available_engines()}"
        )
    return _ENGINES[algorithm]


# ---------------------------------------------------------------------------
# Public functions
# ---------------------------------------------------------------------------


def _normalize_values(values) -> Tuple[Tuple[jax.Array, ...], bool, bool]:
    """Returns (value_tuple, had_values, was_single)."""
    if values is None:
        return (), False, False
    if isinstance(values, (tuple, list)):
        return tuple(values), True, False
    return (values,), True, True


@functools.partial(
    jax.jit,
    static_argnames=(
        "descending",
        "begin_bit",
        "end_bit",
        "algorithm",
        "dimension",
        "cfg",
    ),
)
def _sort_impl(
    keys,
    values_tuple,
    *,
    descending: bool,
    begin_bit: int,
    end_bit: Optional[int],
    algorithm: str,
    dimension: int,
    cfg: Optional[_configs.SortConfig] = None,
):
    if dimension != 0 or keys.ndim != 1:
        raise NotImplementedError("tpusort currently sorts 1-D arrays")
    planes, traits = _dtypes.twiddle_in(keys, descending=descending)
    total_bits = traits.bits
    eb = total_bits if end_bit is None else end_bit
    if not (0 <= begin_bit < eb <= total_bits):
        raise ValueError(f"invalid bit range [{begin_bit}, {eb}) for {traits.name}")
    if cfg is None:
        cfg = _configs.get_config(total_bits, bool(values_tuple))
    engine = _resolve_engine(algorithm, cfg)
    sorted_planes, sorted_values = _call_engine(
        engine,
        planes,
        values_tuple,
        begin_bit=begin_bit,
        end_bit=eb,
        total_bits=total_bits,
        config=cfg,
    )
    out_keys = _dtypes.twiddle_out(
        sorted_planes, traits, descending=descending, dtype=keys.dtype
    )
    return out_keys, sorted_values


# ---------------------------------------------------------------------------
# Host-owned tiering (the reference's CPU-in-the-loop planner analog,
# ``msb/src/sort/gpu_radix_sort.cu:29-104``: the host plans while the GPU
# runs — its planner overlaps the device via streams,
# ``msb/src/sort/gpu_radix_sort.h:240-257``).  Applies to the radix
# engines (msd/lsd/msd_unstable) on concrete inputs; the chain is
# radix -> exact, and keeps host syncs off the common path:
#
# * **tier-decision cache**: the classification for a
#   (shape, dtype, distribution-class) is remembered across calls, so a
#   steady workload dispatches its sort immediately;
# * **overlapped classification**: the strided-sample graph is dispatched
#   BEFORE the sort, and fetched while the sort runs; the result refreshes
#   the cache for the next call.  A sample that predicts radix overflow
#   sends the call straight to the exact tier;
# * **in-graph safety net instead of a flag readback**: where the in-graph
#   fallback fits the device (``cond_fallback_fits``) the radix tier runs
#   with its lax.cond overflow fallback (exactly what jit callers get), so
#   no host sync is needed for correctness.  Above that the cond branch's
#   workspace reservation would not fit, and the flag-mode chain (one
#   overflow-flag readback, then the exact tier) applies.
# ---------------------------------------------------------------------------

_TIERED_ALGOS = ("msd", "lsd", "msd_unstable")

# (shape, dtypes, flags, cfg) -> {"presorted": bool, "tier": str}
_TIER_CACHE: Dict[tuple, dict] = {}


@functools.partial(
    jax.jit,
    static_argnames=("descending", "begin_bit", "end_bit", "tier", "cfg",
                     "mode"),
)
def _sort_tier_impl(
    keys,
    values_tuple,
    *,
    descending: bool,
    begin_bit: int,
    end_bit: Optional[int],
    tier: str,
    cfg: _configs.SortConfig,
    mode: str = "flag",
):
    planes, traits = _dtypes.twiddle_in(keys, descending=descending)
    sp, sv, ovf = _run_tier(planes, values_tuple, traits.bits, begin_bit,
                            end_bit, tier, cfg, mode)
    out_keys = _dtypes.twiddle_out(
        sp, traits, descending=descending, dtype=keys.dtype
    )
    return out_keys, sv, ovf


def _run_tier(planes, values_tuple, total_bits, begin_bit, end_bit, tier,
              cfg, mode):
    """One tier on twiddled planes -> (planes, values, overflow flag)."""
    from tpusort.ops.msd import sort_twiddled_msd

    eb = total_bits if end_bit is None else end_bit
    kw = dict(begin_bit=begin_bit, end_bit=eb, total_bits=total_bits)
    if tier == "radix" and mode == "cond":
        # in-graph overflow fallback (identical to the jit path): one
        # dispatch, no flag readback
        sp, sv = sort_twiddled_msd(planes, values_tuple, on_overflow="cond",
                                   config=cfg, **kw)
        return sp, sv, jnp.asarray(False)
    if tier == "radix":
        return sort_twiddled_msd(planes, values_tuple, on_overflow="flag",
                                 config=cfg, **kw)
    sp, sv = sort_twiddled_reference(planes, values_tuple, **kw)
    return sp, sv, jnp.asarray(False)


@functools.partial(jax.jit, static_argnames=("stride", "descending"))
def _planner_sample_impl(keys, stride: int, descending: bool):
    planes, _ = _dtypes.twiddle_in(keys, descending=descending)
    p0 = planes[0]
    return jax.lax.slice(p0, (0,), (p0.shape[0],), (stride,))


@functools.partial(jax.jit, static_argnames=("stride", "key_dtype",
                                             "descending"))
def _planner_sample_planes_impl(planes, stride: int, key_dtype: str,
                                descending: bool):
    traits = _dtypes.traits_for(key_dtype)
    tw = _dtypes.twiddle_planes_in(
        tuple(jnp.asarray(p).view(jnp.uint32) for p in planes),
        traits, descending=descending,
    )
    return jax.lax.slice(tw[0], (0,), (tw[0].shape[0],), (stride,))


def _lex_sorted(planes):
    """Lexicographic non-decreasing check over twiddled uint32 planes."""
    lt = jnp.zeros(planes[0].shape[0] - 1, bool)
    eq = jnp.ones(planes[0].shape[0] - 1, bool)
    for p in planes:
        lt = lt | (eq & (p[:-1] < p[1:]))
        eq = eq & (p[:-1] == p[1:])
    return jnp.all(lt | eq)


@functools.partial(jax.jit, static_argnames=("descending",))
def _is_sorted_keys_impl(keys, descending: bool):
    """Fused twiddle + sortedness -> scalar (no full-size twiddled
    intermediate is ever committed; XLA fuses the twiddle into the
    reduction — at 2^30 a materialized plane would be 4 GiB of device
    memory)."""
    planes, _ = _dtypes.twiddle_in(keys, descending=descending)
    return _lex_sorted(planes)


@functools.partial(jax.jit, static_argnames=("key_dtype", "descending"))
def _is_sorted_planes_impl(planes, key_dtype: str, descending: bool):
    traits = _dtypes.traits_for(key_dtype)
    tw = _dtypes.twiddle_planes_in(
        tuple(jnp.asarray(p).view(jnp.uint32) for p in planes),
        traits, descending=descending,
    )
    return _lex_sorted(tw)


def _skip_radix_tier(sample, n, begin_bit, end_bit, total_bits,
                     cfg) -> bool:
    """Host pre-classifier (the reference's CPU planner analog,
    gpu_radix_sort.cu:29-104): predict from a strided sample whether the
    radix tier's static capacities are doomed, and skip straight to the
    exact tier if so.  Mispredictions are safe — the flag-mode overflow
    check (or the in-graph cond fallback) still guards correctness."""
    from tpusort import planner
    from tpusort.ops import msd as _msd

    eb = total_bits if end_bit is None else end_bit
    if sample is None or begin_bit != 0 or eb != total_bits:
        return False
    kwargs = {k: v for k, v in cfg.plan_kwargs().items() if k != "min_n"}
    plan = _msd.plan_msd(n, 0, eb, **kwargs)
    if plan is None:
        return False
    return planner.predict_radix_overflow(sample, plan, n)


def _run_tier_chain(dispatch, skip_radix=False, cond_ok=False,
                    first_sync=None):
    """Run the tiers (radix, then exact) until one succeeds.

    ``dispatch(tier, mode)`` -> (keys, values, overflow).  With
    ``cond_ok`` the radix tier carries its own in-graph fallback (single
    dispatch, no readback); otherwise its overflow flag is read back and
    the exact tier re-dispatched.  ``skip_radix`` starts at the exact
    tier.  ``first_sync`` (the cache refresh) runs right after the first
    dispatch so its host round trip overlaps the running sort."""
    tiers = ("exact",) if skip_radix else ("radix", "exact")
    out_k = out_v = None
    for i, tier in enumerate(tiers):
        if out_k is not None:
            del out_k, out_v      # free the overflowed tier's garbage
        mode = "cond" if cond_ok and tier == "radix" else "flag"
        out_k, out_v, ovf = dispatch(tier, mode)
        if first_sync is not None:
            first_sync()
            first_sync = None
        if mode == "cond" or i == len(tiers) - 1 or not bool(ovf):
            break
    return out_k, out_v


def _tiered_flow(ckey, n, n_ops, classify, decide, dispatch, identity):
    """The host tiering flow shared by ``sort`` and ``sort_planes``.

    ``classify``: None (problem too small / sub-range sort — dispatch the
    default chain with zero host syncs), or ``(sample_dev, check_fn)``
    where ``sample_dev`` is the ALREADY-DISPATCHED strided-sample device
    array (queued ahead of the sort, so fetching it overlaps the sort's
    device time) and ``check_fn`` runs the fused full-input sortedness
    check.  ``decide(sample) -> (presorted_likely, tier)`` is the host
    classifier; its result is cached under ``ckey`` so steady workloads
    skip the classify wait entirely.  ``identity()`` returns the
    presorted short-circuit output (the reference's finished buckets
    skipping every remaining pass, gpu_radix_sort.h:359-360,482-485,
    taken to the limit — constant keys included)."""
    cond_ok = cond_fallback_fits(n, n_ops)
    if classify is None:
        return _run_tier_chain(dispatch, cond_ok=cond_ok)
    sample_dev, check_fn = classify
    if len(_TIER_CACHE) > 256:
        _TIER_CACHE.clear()
    cached = _TIER_CACHE.get(ckey)
    if cached is None or cached["presorted"]:
        # cold (or presorted-likely): classify BEFORE dispatching the
        # sort, so a presorted input costs one comparison pass, not a sort
        presorted, tier = decide(np.asarray(sample_dev))
        if presorted and bool(np.asarray(check_fn())):
            _TIER_CACHE[ckey] = {"presorted": True, "tier": tier}
            return identity()
        _TIER_CACHE[ckey] = {"presorted": False, "tier": tier}
        return _run_tier_chain(dispatch, skip_radix=(tier == "exact"),
                               cond_ok=cond_ok)
    # steady state: dispatch by the cached tier immediately; the classify
    # fetch runs while the sort executes and refreshes the cache
    tier = cached["tier"]

    def refresh():
        p, t = decide(np.asarray(sample_dev))
        _TIER_CACHE[ckey] = {"presorted": p, "tier": t}

    return _run_tier_chain(dispatch, skip_radix=(tier == "exact"),
                           cond_ok=cond_ok, first_sync=refresh)


def _decider(n, begin_bit, end_bit, total_bits, cfg):
    """Host classifier: (presorted_likely, first tier) from a sample."""
    from tpusort import planner

    def decide(sample):
        presorted = planner.predict_presorted([sample])
        tier = "exact" if _skip_radix_tier(
            sample, n, begin_bit, end_bit, total_bits, cfg) else "radix"
        return presorted, tier

    return decide


def _sort_host_tiered(keys, vt, *, descending, begin_bit, end_bit, cfg):
    from tpusort import planner

    kw = dict(descending=descending, begin_bit=begin_bit, end_bit=end_bit,
              cfg=cfg)
    n = keys.shape[0]
    total_bits = _dtypes.key_bits(keys.dtype)
    eb = total_bits if end_bit is None else end_bit

    def dispatch(tier, mode):
        return _sort_tier_impl(keys, vt, tier=tier, mode=mode, **kw)

    def identity():
        # coerce: the tier-chain path returns JAX arrays for values, so
        # the identity short-circuit must too (callers may pass numpy
        # arrays / lists)
        return keys, tuple(jnp.asarray(v) for v in vt)

    classify = None
    if begin_bit == 0 and eb == total_bits and n >= planner.PLANNER_MIN_N:
        stride = max(1, n // planner.SAMPLE_TARGET)
        classify = (
            _planner_sample_impl(keys, stride, descending),
            lambda: _is_sorted_keys_impl(keys, descending),
        )
    ckey = ("k", n, str(keys.dtype),
            tuple(str(getattr(v, "dtype", "?")) for v in vt),
            descending, begin_bit, eb, cfg)
    return _tiered_flow(ckey, n, 1 + len(vt), classify,
                        _decider(n, begin_bit, end_bit, total_bits, cfg),
                        dispatch, identity)


def _host_tiered_applicable(keys, values_tuple, algorithm, cfg) -> bool:
    """Host tiering needs a concrete (non-traced) input — inside a user's
    jit the in-graph lax.cond fallback applies instead — and one of the
    radix engines."""
    if isinstance(keys, jax.core.Tracer):
        return False
    algo = cfg.default_algorithm if algorithm == "auto" else algorithm
    if algo not in _TIERED_ALGOS:
        return False
    return not any(isinstance(v, jax.core.Tracer) for v in values_tuple)


def _op_dtype(a) -> np.dtype:
    """Array-like dtype without materializing or transferring anything."""
    d = getattr(a, "dtype", None)
    return np.dtype(d) if d is not None else np.asarray(a).dtype


def _sort_64bit_boundary(keys, vt, had, single, kd, *, descending,
                         begin_bit, end_bit, algorithm, stable):
    """Host-side 64-bit boundary: with ``jax_enable_x64`` off JAX holds no
    64-bit arrays, so 64-bit keys/values are bitcast into uint32 planes ON
    THE HOST, sorted through the plane interface, and reassembled.  This
    makes the public ``sort()`` accept every key dtype of the reference's
    ``Traits`` (``lsb/cub/cub/util_type.cuh:1104-1130``) and the full
    {4,8}-byte key x value tuning matrix
    (``msb/src/sort/gpu_sort_config.h:146-207``).  64-bit operands come
    back as numpy arrays (no JAX array can hold them with x64 off); 32-bit
    payloads stay device arrays."""
    if np.asarray(keys).ndim != 1:
        raise NotImplementedError("tpusort currently sorts 1-D arrays")
    if kd.itemsize == 8:
        planes = _dtypes.split64_host(keys)
        key_dtype = kd.name
    else:
        planes = (np.ascontiguousarray(np.asarray(keys)).view(np.uint32),)
        key_dtype = kd.name
    proc_vals: list = []
    spec = []
    for v in vt:
        vd = _op_dtype(v)
        if vd.itemsize == 8:
            vhi, vlo = _dtypes.split64_host(v)
            proc_vals += [vhi, vlo]
            spec.append(("v64", vd))
        else:
            proc_vals.append(v)
            spec.append(("v32", vd))
    out = sort_planes(
        planes, proc_vals or None, key_dtype=key_dtype,
        descending=descending, begin_bit=begin_bit, end_bit=end_bit,
        algorithm=algorithm, stable=stable,
    )
    out_planes = out[0] if had else out
    if kd.itemsize == 8:
        out_keys = _dtypes.join64_host(out_planes[0], out_planes[1], kd)
    else:
        out_keys = np.asarray(out_planes[0]).view(kd)
    if not had:
        return out_keys
    raw = list(out[1])
    out_vals = []
    for kind, vd in spec:
        if kind == "v64":
            vhi, vlo = raw.pop(0), raw.pop(0)
            out_vals.append(_dtypes.join64_host(vhi, vlo, vd))
        else:
            # 32-bit payloads come back already viewed to their dtype
            out_vals.append(raw.pop(0))
    return out_keys, (out_vals[0] if single else tuple(out_vals))


def sort(
    keys: jax.Array,
    values=None,
    *,
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    algorithm: str = "auto",
    stable: bool = True,
):
    """Radix sort of ``keys`` (optionally carrying ``values``).

    Parameters mirror the reference API surface: ``descending`` (CUB
    ``SortKeysDescending``/``SortPairsDescending``), ``begin_bit``/``end_bit``
    sub-range comparison, and ``values`` as either a single array or a tuple
    of payload arrays.  ``stable=False`` permits reordering of equal-key
    payloads for speed (the reference MSB sort's semantics,
    ``msb/src/sort/gpu_radix_sort.h:197``); keys-only output is identical
    either way.  Returns sorted keys, or ``(keys, values)`` when values are
    given.

    64-bit key/value dtypes (uint64/int64/float64) are accepted even when
    ``jax_enable_x64`` is off and JAX holds no 64-bit arrays: they are
    split into uint32 planes at the host boundary and reassembled, so
    those operands return as numpy arrays (see :func:`sort_planes` for the
    fully device-resident 64-bit interface).
    """
    vt, had, single = _normalize_values(values)
    kd = _op_dtype(keys)
    if not jax.config.jax_enable_x64 and (
        kd.itemsize == 8
        or any(_op_dtype(v).itemsize == 8 for v in vt)
    ):
        if isinstance(keys, jax.core.Tracer) or any(
            isinstance(v, jax.core.Tracer) for v in vt
        ):
            raise NotImplementedError(
                "64-bit operands inside jit require the plane interface "
                "(sort_planes); the host bitcast boundary needs concrete "
                "arrays"
            )
        return _sort_64bit_boundary(
            keys, vt, had, single, kd, descending=descending,
            begin_bit=begin_bit, end_bit=end_bit, algorithm=algorithm,
            stable=stable,
        )
    # validate BEFORE choosing a dispatch path: the host-tiered route must
    # reject exactly what _sort_impl rejects (a 2-D input would otherwise
    # be silently column-"sorted" by the reference tier)
    keys = jnp.asarray(keys)
    if keys.ndim != 1:
        raise NotImplementedError("tpusort currently sorts 1-D arrays")
    total_bits = _dtypes.key_bits(keys.dtype)
    eb_chk = total_bits if end_bit is None else end_bit
    if not (0 <= begin_bit < eb_chk <= total_bits):
        raise ValueError(
            f"invalid bit range [{begin_bit}, {eb_chk}) for {keys.dtype}"
        )
    # resolve the tuning config OUTSIDE the jit boundary (it is a static
    # argument): registry updates then retrace instead of being shadowed by
    # the trace cache
    cfg = _configs.get_config(total_bits, had)
    if _host_tiered_applicable(keys, vt, algorithm, cfg):
        out_keys, out_vals = _sort_host_tiered(
            keys, vt, descending=descending, begin_bit=begin_bit,
            end_bit=end_bit, cfg=cfg,
        )
        if not had:
            return out_keys
        return out_keys, (out_vals[0] if single else out_vals)
    out_keys, out_vals = _sort_impl(
        keys,
        vt,
        descending=descending,
        begin_bit=begin_bit,
        end_bit=end_bit,
        algorithm=algorithm,
        dimension=0,
        cfg=cfg,
    )
    if not had:
        return out_keys
    return out_keys, (out_vals[0] if single else out_vals)


@functools.partial(jax.jit, static_argnames=("descending",))
def _argsort_twiddle_impl(k, descending):
    planes, _ = _dtypes.twiddle_in(k, descending=descending)
    return planes[0]


def argsort(
    keys: jax.Array,
    *,
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    algorithm: str = "auto",
):
    """Indices that stably sort ``keys``.

    Full-range 32-bit sorts through the radix engines (and ``auto``) sort
    the composite 64-bit key (twiddled key || index) as planes: the index
    plane is both the stable tiebreak and the requested output, so no
    payload is carried.  Sub-range/bit-window argsorts delegate to the
    stable pairs path.
    """
    idx = jnp.arange(keys.shape[0], dtype=jnp.uint32)
    total = _dtypes.key_bits(keys.dtype)
    eb = total if end_bit is None else end_bit
    if begin_bit == 0 and eb == total == 32 and \
            algorithm in ("auto", "msd", "lsd"):
        tw = _argsort_twiddle_impl(keys, descending)
        out = sort_planes(
            (tw, idx), key_dtype="uint64", stable=False,
            algorithm=algorithm,
        )
        return out[1]
    _, perm = sort(
        keys,
        idx,
        descending=descending,
        begin_bit=begin_bit,
        end_bit=end_bit,
        algorithm=algorithm,
    )
    return perm


# CUB-flavored convenience wrappers (device_radix_sort.cuh:147-660)


def sort_keys(keys, **kw):
    return sort(keys, **kw)


def sort_keys_descending(keys, **kw):
    return sort(keys, descending=True, **kw)


def sort_pairs(keys, values, **kw):
    return sort(keys, values, **kw)


def sort_pairs_descending(keys, values, **kw):
    return sort(keys, values, descending=True, **kw)


# MSB-flavored unstable entry points (rdxsrt_unstable_sort_keys/pairs,
# msb/src/sort/gpu_radix_sort.h:511-587)


def unstable_sort_keys(keys, **kw):
    return sort(keys, stable=False, **kw)


@functools.partial(
    jax.jit,
    static_argnames=("key_dtype", "descending", "begin_bit", "end_bit",
                     "algorithm", "cfg"),
)
def _sort_planes_impl(planes, values_tuple, *, key_dtype, descending,
                      begin_bit, end_bit, algorithm, cfg=None):
    traits = _dtypes.traits_for(key_dtype)
    if len(planes) != traits.planes:
        raise ValueError(
            f"{key_dtype} expects {traits.planes} uint32 plane(s), "
            f"got {len(planes)}"
        )
    tw = _dtypes.twiddle_planes_in(
        tuple(jnp.asarray(p).view(jnp.uint32) for p in planes),
        traits, descending=descending,
    )
    total_bits = traits.bits
    eb = total_bits if end_bit is None else end_bit
    if not (0 <= begin_bit < eb <= total_bits):
        raise ValueError(f"invalid bit range [{begin_bit}, {eb})")
    if cfg is None:
        cfg = _configs.get_config(total_bits, bool(values_tuple))
    engine = _resolve_engine(algorithm, cfg)
    sp, sv = _call_engine(
        engine, tw, values_tuple, begin_bit=begin_bit, end_bit=eb,
        total_bits=total_bits, config=cfg,
    )
    out = _dtypes.twiddle_planes_out(sp, traits, descending=descending)
    return tuple(out), sv


@functools.partial(
    jax.jit,
    static_argnames=("key_dtype", "descending", "begin_bit", "end_bit",
                     "tier", "cfg", "mode"),
)
def _sort_planes_tier_impl(planes, values_tuple, *, key_dtype, descending,
                           begin_bit, end_bit, tier, cfg,
                           mode: str = "flag"):
    traits = _dtypes.traits_for(key_dtype)
    tw = _dtypes.twiddle_planes_in(
        tuple(jnp.asarray(p).view(jnp.uint32) for p in planes),
        traits, descending=descending,
    )
    sp, sv, ovf = _run_tier(tw, values_tuple, traits.bits, begin_bit,
                            end_bit, tier, cfg, mode)
    out = _dtypes.twiddle_planes_out(sp, traits, descending=descending)
    return tuple(out), sv, ovf


def sort_planes(
    planes,
    values=None,
    *,
    key_dtype: str = "uint64",
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    algorithm: str = "auto",
    stable: bool = True,
):
    """Sort keys supplied as raw uint32 bit-pattern planes — the
    device-resident 64-bit interface.

    With ``jax_enable_x64`` off JAX holds no 64-bit arrays, so 64-bit keys
    live as ``(hi, lo)`` uint32 planes end to end (plane 0 =
    most-significant word).  ``key_dtype`` names the logical
    key type (uint64/int64/float64 — or the 32-bit types with one plane) and
    selects the order-preserving twiddle.  Returns the sorted planes (and
    values, if given).  The 64-bit analog of the reference's templated
    ``rdxsrt_unstable_sort<KeyT>`` 64-bit instantiations
    (``msb/src/sort/gpu_radix_sort.h:190-205``).
    """
    vt, had, single = _normalize_values(values)
    traits_chk = _dtypes.traits_for(key_dtype)
    if len(planes) != traits_chk.planes:
        raise ValueError(
            f"{key_dtype} expects {traits_chk.planes} uint32 plane(s), "
            f"got {len(planes)}"
        )
    eb_chk = traits_chk.bits if end_bit is None else end_bit
    if not (0 <= begin_bit < eb_chk <= traits_chk.bits):
        raise ValueError(f"invalid bit range [{begin_bit}, {eb_chk})")
    cfg = _configs.get_config(traits_chk.bits, had)
    if _host_tiered_applicable(planes[0], vt, algorithm, cfg):
        from tpusort import planner

        kw = dict(key_dtype=key_dtype, descending=descending,
                  begin_bit=begin_bit, end_bit=end_bit, cfg=cfg)
        pt = tuple(planes)
        n_pl = np.shape(pt[0])[0]
        tb_pl = traits_chk.bits

        def dispatch(tier, mode):
            return _sort_planes_tier_impl(pt, vt, tier=tier, mode=mode,
                                          **kw)

        def identity():
            # match the normal path's output type exactly (uint32 jax
            # arrays), whatever array-likes the caller passed
            out_id = tuple(jnp.asarray(p).view(jnp.uint32) for p in pt)
            return out_id, tuple(jnp.asarray(v) for v in vt)

        classify = None
        if begin_bit == 0 and eb_chk == tb_pl and \
                n_pl >= planner.PLANNER_MIN_N:
            stride = max(1, n_pl // planner.SAMPLE_TARGET)
            classify = (
                _planner_sample_planes_impl(pt, stride, key_dtype,
                                            descending),
                lambda: _is_sorted_planes_impl(pt, key_dtype, descending),
            )
        ckey = ("p", n_pl, key_dtype,
                tuple(str(getattr(v, "dtype", "?")) for v in vt), descending,
                begin_bit, eb_chk, cfg)
        out_planes, out_vals = _tiered_flow(
            ckey, n_pl, len(pt) + len(vt), classify,
            _decider(n_pl, begin_bit, end_bit, tb_pl, cfg),
            dispatch, identity)
        if not had:
            return out_planes
        return out_planes, (out_vals[0] if single else out_vals)
    out_planes, out_vals = _sort_planes_impl(
        tuple(planes), vt, key_dtype=key_dtype, descending=descending,
        begin_bit=begin_bit, end_bit=end_bit, algorithm=algorithm,
        cfg=cfg,
    )
    if not had:
        return out_planes
    return out_planes, (out_vals[0] if single else out_vals)


def unstable_sort_pairs(keys, values, **kw):
    return sort(keys, values, stable=False, **kw)


@functools.partial(
    jax.jit, static_argnames=("num_lsb_bytes", "descending")
)
def _lsb_in_value_impl(keys, values, *, num_lsb_bytes: int,
                       descending: bool):
    from tpusort.ops.msd import sort_twiddled_msd

    planes, traits = _dtypes.twiddle_in(keys, descending=False)
    if traits.planes != 1:
        raise NotImplementedError(
            "lsb-in-value needs a free plane slot: 32-bit key dtypes only"
        )
    v_u32 = jnp.asarray(values).view(jnp.uint32)
    mask = jnp.uint32((1 << (8 * num_lsb_bytes)) - 1) \
        if num_lsb_bytes < 4 else jnp.uint32(0xFFFFFFFF)
    comp = [planes[0], v_u32 & mask]
    if descending:
        comp = [~p for p in comp]
    sp, sv = sort_twiddled_msd(
        tuple(comp), (v_u32,), begin_bit=0, end_bit=64, total_bits=64,
    )
    k_plane = ~sp[0] if descending else sp[0]
    out_keys = _dtypes.twiddle_out((k_plane,), traits, descending=False,
                                   dtype=keys.dtype)
    return out_keys, sv[0].view(jnp.asarray(values).dtype)


def sort_pairs_lsb_in_value(
    keys, values, num_lsb_bytes: int = 4, *, descending: bool = False
):
    """Unstable pair sort by the composite key (key || low
    ``num_lsb_bytes`` bytes of the value).

    The analog of the reference's ``NUM_LSB_IN_VALUE`` capability
    (``msb/src/sort/gpu_radix_sort.h:195-206,367-368``: low-order key bytes
    stored in the value word, sorted via the pointer-swap trick).  Here the
    masked value bytes simply ride as the second key plane, and the full
    value is carried as payload.
    """
    if not 1 <= num_lsb_bytes <= 4:
        raise ValueError("num_lsb_bytes must be in 1..4")
    if jnp.dtype(jnp.asarray(values).dtype).itemsize != 4:
        raise ValueError("values must be a 32-bit dtype")
    return _lsb_in_value_impl(
        keys, values, num_lsb_bytes=num_lsb_bytes, descending=descending
    )
