"""Benchmark/profiling harness.

Re-design of the reference's benchmark framework
(``msb/external/benchmark/benchmark.h:1-736``): profiles are tables, runs
are rows, metrics are columns (``benchmark.h:11-29``), with typed data
points, per-pass metric arrays (``:666-727`` — used as
histo/pfx_sum/scatter/local_sort[pass] in ``gpu_radix_sort.h:266-269``),
and table/CSV writers with min/max/avg summaries (``:364-605``).

The CUDA-event machinery maps to :mod:`tpusort.utils.timing`
(``block_until_ready`` around each call); lazily-resolved event pairs are
unnecessary since measurement is synchronous here.
"""

from __future__ import annotations

import csv
import io
import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpusort.utils import timing

__all__ = ["Profile", "Run", "profile_msd_phases"]


@dataclass
class Run:
    """One row: a dict of metric -> value, plus per-pass metric arrays."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    arrays: Dict[str, List[float]] = field(default_factory=dict)

    def set_metric(self, name: str, value) -> None:
        self.metrics[name] = value

    def push(self, name: str, value: float) -> None:
        """Append to a per-pass metric array (histo/scatter/... per pass)."""
        self.arrays.setdefault(name, []).append(value)

    @contextmanager
    def time_metric(self, name: str, *, per_pass: bool = False):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        if per_pass:
            self.push(name, dt * 1e3)
        else:
            self.metrics[name] = dt * 1e3


class Profile:
    """A named table of runs (BM_OPEN_PROFILE/BM_CLOSE_PROFILE analog)."""

    def __init__(self, name: str):
        self.name = name
        self.runs: List[Run] = []

    @contextmanager
    def run(self, **metrics):
        r = Run(dict(metrics))
        self.runs.append(r)
        yield r

    # ----- output (table/CSV/JSON writers + summaries) -----

    def _columns(self) -> List[str]:
        cols: List[str] = []
        for r in self.runs:
            for k in list(r.metrics) + [
                f"{a}[{i}]" for a, v in r.arrays.items() for i in range(len(v))
            ]:
                if k not in cols:
                    cols.append(k)
        return cols

    def _cell(self, r: Run, col: str):
        if col in r.metrics:
            return r.metrics[col]
        if "[" in col:
            a, i = col[:-1].split("[")
            vals = r.arrays.get(a, [])
            return vals[int(i)] if int(i) < len(vals) else ""
        return ""

    def table(self) -> str:
        cols = self._columns()
        rows = [[_fmt(self._cell(r, c)) for c in cols] for r in self.runs]
        summary = _summaries(self, cols)
        widths = [
            max(len(c), *(len(row[i]) for row in rows + summary))
            for i, c in enumerate(cols)
        ] if rows else [len(c) for c in cols]
        out = [f"== {self.name} =="]
        out.append(" | ".join(c.ljust(w) for c, w in zip(cols, widths)))
        out.append("-+-".join("-" * w for w in widths))
        for row in rows:
            out.append(" | ".join(v.ljust(w) for v, w in zip(row, widths)))
        if len(rows) > 1:
            out.append("-+-".join("-" * w for w in widths))
            for row in summary:
                out.append(" | ".join(v.ljust(w) for v, w in zip(row, widths)))
        return "\n".join(out)

    def csv(self) -> str:
        cols = self._columns()
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(cols)
        for r in self.runs:
            w.writerow([self._cell(r, c) for c in cols])
        return buf.getvalue()

    def json_lines(self) -> str:
        out = []
        for r in self.runs:
            d = dict(r.metrics)
            d.update({a: v for a, v in r.arrays.items()})
            out.append(json.dumps(d, default=str))
        return "\n".join(out)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def _summaries(p: Profile, cols: List[str]) -> List[List[str]]:
    rows = []
    for agg_name, agg in (("min", min), ("max", max),
                          ("avg", lambda v: sum(v) / len(v))):
        row = []
        for c in cols:
            vals = [
                p._cell(r, c) for r in p.runs
                if isinstance(p._cell(r, c), (int, float))
            ]
            row.append(_fmt(agg(vals)) + f" ({agg_name})" if vals else "")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Per-phase MSD profiling (the per-pass metric-array analog)
# ---------------------------------------------------------------------------


def profile_msd_phases(n: int, *, dtype="uint32", pairs: bool = False,
                       seed: int = 0, fused_total: bool = True) -> Profile:
    """Time each MSD engine phase separately on the current backend:
    each partition pass (histogram, tile sort, padded emit, exchange
    transpose); leaf; compaction (``collapse_ms``).

    The jit-fused production path is faster than the sum of these (no
    intermediate materialization), so treat them as an upper bound per
    phase — the tool for finding which pass to optimize, exactly how the
    reference used its per-pass arrays (gpu_radix_sort.h:266-269).
    """
    import jax
    import jax.numpy as jnp

    from tpusort import dtypes as td
    from tpusort.ops import msd
    from tpusort.utils import datagen

    prof = Profile(f"msd_phases_n{n}_{dtype}{'_pairs' if pairs else ''}")
    keys = datagen.random_keys(jax.random.key(seed), n, dtype)
    planes, traits = td.twiddle_in(keys)
    plan = msd.plan_msd(n, 0, traits.bits)
    if plan is None:
        raise ValueError(f"no msd plan for n={n}")

    with prof.run(n=n, dtype=dtype, pairs=pairs,
                  passes=len(plan.passes), seg=plan.seg) as r:
        ops = [jnp.pad(p, (0, plan.m1 - n)) for p in planes]
        if pairs:
            ops.append(jnp.pad(jnp.arange(n, dtype=jnp.uint32),
                               (0, plan.m1 - n)))
        k0 = plan.passes[0].k
        run_counts = jnp.clip(
            n - jnp.arange(plan.m1 // k0, dtype=jnp.int32) * k0, 0, k0)
        s_prev = k0
        for i, spec in enumerate(plan.passes):
            fn = jax.jit(lambda o, rc, sp=spec, s_p=s_prev: msd._partition_pass(
                list(o), slice(0, traits.planes), rc, s_p, sp))
            dt = timing.measure(fn, tuple(ops), run_counts)
            r.push("partition_ms", dt * 1e3)
            ops, run_counts, _ = fn(tuple(ops), run_counts)
            ops = list(ops)
            s_prev = spec.s
        leaf = jax.jit(lambda o, rc: msd._leaf_sort(
            list(o), slice(0, traits.planes),
            msd._valid_mask(rc, s_prev, plan.n_segments, plan.seg),
            plan))
        dt = timing.measure(leaf, tuple(ops), run_counts)
        r.set_metric("leaf_ms", dt * 1e3)
        ops, seg_counts = leaf(tuple(ops), run_counts)
        coll = jax.jit(lambda o, sc: msd.compact_segments(
            list(o), sc, plan.seg, n))
        dt = timing.measure(coll, tuple(ops), seg_counts)
        r.set_metric("collapse_ms", dt * 1e3)
        if fused_total:
            # end-to-end production path for the per-phase upper-bound
            # comparison (skippable where only the phases matter)
            total = jax.jit(
                lambda k: __import__("tpusort").sort(k, algorithm="msd"))
            dt = timing.measure(total, keys)
            r.set_metric("fused_total_ms", dt * 1e3)
            r.set_metric("keys_per_s", n / dt)
    return prof
