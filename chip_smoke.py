"""Smoke test of tpusort on NVIDIA GPUs: the public API at full size.

Drives every main-path entry point once, through the calls a user makes
(``algorithm="auto"`` unless a phase names an engine), at the reference's
own size of 2^28 32-bit keys (``msb/src/test.cu:64``, ``lsb/sort.cu``
2^28 trials).  Every result is checked bitwise: against the numpy oracle
(``tests/oracle.py``) at up to 2^24 keys, and by in-graph checks
(``tpusort.utils.checks``) at 2^28.  Sorting is exact, so no tolerance
applies anywhere.

    python chip_smoke.py             # one card: phases a-i
    python chip_smoke.py --cards 4   # four cards: the global sort only

Prints one JSON line per phase (median keys/s of 5 timed calls after a
warm-up, the sorts XLA compiled the call into, the card), then the card's
name and power limit, then, last, ``{"ok": true, "device": {...}}``.  Any
failed check ends the run with a non-zero exit before that line; so does a
machine without a GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import statistics
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import tpusort
from tpusort.parallel.global_sort import (
    make_global_sort, make_global_sort_planes)
from tpusort.utils import datagen, device, timing
from tpusort.utils.checks import sort_checks

ROOT = os.path.dirname(os.path.abspath(__file__))
FULL = 1 << 28


def _require(ok, what: str) -> None:
    if not bool(ok):
        raise SystemExit(f"chip_smoke: check failed: {what}")


def require_gpu(backend: str) -> None:
    """Refuse to run anywhere but on a GPU (no CPU carry-on)."""
    if backend != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX's backend is {backend!r}")


def lowering(fn, *args) -> dict:
    """How XLA compiled ``fn(*args)``: the number of sorts handed to CUB's
    radix sort (custom calls) and of XLA's own comparison sorts."""
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    cub = len(re.findall(r'custom_call_target="[^"]*[Cc]ub[^"]*"', hlo))
    return {"cub_radix_sort": cub,
            "xla_sort": len(re.findall(r"\bsort\(", hlo))}


def require_no_pallas_call(fn, *args) -> None:
    _require("pallas_call" not in str(jax.make_jaxpr(fn)(*args)),
             f"{getattr(fn, '__name__', fn)} traces a pallas_call")


# ---------------------------------------------------------------------------
# Host-side exact checks (small sizes)
# ---------------------------------------------------------------------------


def _oracle_module():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle

    return oracle


def _oracle():
    return _oracle_module().np_sort_oracle


def exact_equal(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and \
        np.array_equal(got.view(np.uint8), want.view(np.uint8))


def rows_bound(keys_in, keys_out, perm) -> bool:
    """Each output row is keys_in's row permuted by ``perm``."""
    keys_in, keys_out, perm = map(np.asarray, (keys_in, keys_out, perm))
    if not np.array_equal(np.sort(perm, axis=-1),
                          np.broadcast_to(np.arange(perm.shape[-1]),
                                          perm.shape)):
        return False
    return exact_equal(np.take_along_axis(keys_in, perm.astype(np.int64),
                                          axis=-1), keys_out)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


class Smoke:
    def __init__(self, iters: int = 5):
        self.iters = iters
        self.dev = device.device_fields()
        self.card = device.gpu_name_and_power_limit()
        self.jax_version = jax.__version__
        self.checks = jax.jit(sort_checks, static_argnames="stable")

    def report(self, phase: str, what: str, n: int, fn, args, lower,
               check: str) -> None:
        """Time ``fn(*args)``, print the phase line."""
        times = timing.measure_all(fn, *args, iters=self.iters)
        med = statistics.median(times)
        print(json.dumps({
            "phase": phase, "what": what, "n": n,
            "keys_per_s": n / med, "median_s": med, "times_s": times,
            "lowering": lower, "check": check, "ok": True,
            "device_kind": self.dev["kind"], "card": self.card,
            "jax": self.jax_version,
        }), flush=True)

    # -- 2^28, in-graph checks ------------------------------------------

    def keys_full(self, n=FULL):
        keys = jax.random.bits(jax.random.key(1), (n,), dtype=jnp.uint32)
        require_no_pallas_call(tpusort.sort, keys)
        _require(self.checks(tpusort.sort(keys), keys), "a: sort u32 keys")
        self.report("a", "sort u32 keys, auto", n, tpusort.sort, (keys,),
                    lowering(tpusort.sort, keys), "in-graph")

    def pairs_full(self, n=FULL):
        keys = jax.random.bits(jax.random.key(2), (n,), dtype=jnp.uint32)
        vals = jnp.arange(n, dtype=jnp.uint32)
        for phase, fn, stable in (("b", tpusort.sort, True),
                                  ("c", tpusort.unstable_sort_pairs, False)):
            require_no_pallas_call(fn, keys, vals)
            ok, ov = fn(keys, vals)
            _require(self.checks(ok, keys, ov, vals, stable=stable),
                     f"{phase}: {fn.__name__} u32 pairs")
            del ok, ov
            self.report(phase, f"{fn.__name__}(keys, arange), "
                        f"{'stable' if stable else 'unstable'}", n, fn,
                        (keys, vals), lowering(fn, keys, vals), "in-graph")

    def skewed_full(self, n=FULL):
        for what, keys in (
            ("AND ladder, entropy level 4",
             datagen.entropy_keys(jax.random.key(3), n, 4, "uint32")),
            ("constant keys", jnp.full((n,), 7, jnp.uint32)),
        ):
            _require(self.checks(tpusort.sort(keys), keys), f"d: {what}")
            self.report("d", f"sort u32 keys, {what}", n, tpusort.sort,
                        (keys,), lowering(tpusort.sort, keys), "in-graph")

    # -- up to 2^24, exact against the oracle ---------------------------

    def argsort_nan(self, n=1 << 24):
        oracle = _oracle()
        x = jax.random.normal(jax.random.key(4), (n,), jnp.float32)
        x = jnp.where(jnp.arange(n) % 97 == 0, jnp.nan, x)
        x = jnp.where(jnp.arange(n) % 89 == 0, -jnp.nan, x)
        fn = functools.partial(tpusort.argsort, descending=True)
        require_no_pallas_call(fn, x)
        xh = np.asarray(x)
        _, want = oracle(xh, np.arange(n, dtype=np.int32), descending=True)
        got = np.asarray(fn(x))
        _require(np.array_equal(got.astype(np.int64), want),
                 "e: argsort float32 with NaNs, descending")
        self.report("e", "argsort f32 with NaNs, descending", n, fn, (x,),
                    lowering(fn, x), "oracle")

    def bit_range(self, n=1 << 24):
        oracle = _oracle()
        keys = jax.random.bits(jax.random.key(5), (n,), dtype=jnp.uint32)
        vals = jnp.arange(n, dtype=jnp.uint32)
        fn = functools.partial(tpusort.sort, begin_bit=8, end_bit=24)
        require_no_pallas_call(fn, keys, vals)
        gk, gv = fn(keys, vals)
        wk, wv = oracle(np.asarray(keys), np.asarray(vals), begin_bit=8,
                        end_bit=24)
        _require(exact_equal(gk, wk) and exact_equal(gv, wv),
                 "f: pairs with begin_bit=8, end_bit=24")
        self.report("f", "sort u32 pairs, begin_bit=8 end_bit=24", n, fn,
                    (keys, vals), lowering(fn, keys, vals), "oracle")

    def wide_keys(self, n=1 << 26):
        oracle = _oracle()
        rng = np.random.default_rng(6)
        k64 = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        want = oracle(k64)
        got = tpusort.sort(k64)           # host plane boundary (x64 off)
        _require(exact_equal(got, want), "g: sort u64 keys")
        hi = jnp.asarray((k64 >> np.uint64(32)).astype(np.uint32))
        lo = jnp.asarray(k64.astype(np.uint32))
        planes_fn = functools.partial(tpusort.sort_planes,
                                      key_dtype="uint64")
        require_no_pallas_call(planes_fn, (hi, lo))
        lower = lowering(planes_fn, (hi, lo))
        self.report("g", "sort u64 keys (host plane boundary)", n,
                    tpusort.sort, (k64,), lower, "oracle")
        ohi, olo = planes_fn((hi, lo))
        _require(exact_equal(np.asarray(ohi), (want >> np.uint64(32))
                             .astype(np.uint32))
                 and exact_equal(np.asarray(olo), want.astype(np.uint32)),
                 "g: sort_planes u64")
        self.report("g", "sort_planes u64 (hi, lo)", n, planes_fn,
                    ((hi, lo),), lower, "oracle")

    def segmented(self, n=1 << 24, nseg=4096, rows=128, cols=1 << 17):
        rng = np.random.default_rng(7)
        keys = jax.random.bits(jax.random.key(8), (n,), dtype=jnp.uint32)
        vals = jnp.arange(n, dtype=jnp.uint32)
        cuts = np.sort(rng.choice(np.arange(1, n), nseg - 1, replace=False))
        offs = jnp.asarray(np.concatenate([[0], cuts, [n]]).astype(np.int32))
        require_no_pallas_call(tpusort.segmented_sort, keys, offs, vals)
        gk, gv = tpusort.segmented_sort(keys, offs, vals)
        kh = np.asarray(keys)
        seg_id = np.searchsorted(np.asarray(offs), np.arange(n),
                                 side="right") - 1
        order = np.lexsort((kh, seg_id))          # stable, by (segment, key)
        _require(exact_equal(gk, kh[order])
                 and exact_equal(gv, np.asarray(vals)[order]),
                 "h: segmented_sort, ragged")
        self.report("h", f"segmented_sort ragged, {nseg} segments", n,
                    tpusort.segmented_sort, (keys, offs, vals),
                    lowering(tpusort.segmented_sort, keys, offs, vals),
                    "oracle")

        x = jax.random.normal(jax.random.key(9), (rows, cols), jnp.float32)
        idx = jnp.broadcast_to(jnp.arange(cols, dtype=jnp.int32),
                               (rows, cols))
        fn = functools.partial(tpusort.sort_batched, descending=True)
        require_no_pallas_call(fn, x, idx)
        bk, bi = fn(x, idx)
        xh = np.asarray(x)
        tw = ~_oracle_module().np_twiddle(xh.ravel()).reshape(rows, cols)
        want = np.take_along_axis(xh, np.argsort(tw, axis=1, kind="stable"),
                                  axis=1)
        _require(exact_equal(bk, want) and rows_bound(x, bk, bi),
                 "h: sort_batched rows, descending, with payload")
        self.report("h", f"sort_batched {rows}x{cols} f32, descending, "
                    "with payload", rows * cols, fn, (x, idx),
                    lowering(fn, x, idx), "oracle")

    def engines(self, msd_n=1 << 24, bitonic_n=1 << 14):
        oracle = _oracle()
        for algo, n in (("msd", msd_n), ("bitonic", bitonic_n)):
            keys = jax.random.bits(jax.random.key(n), (n,),
                                   dtype=jnp.uint32)
            fn = functools.partial(tpusort.sort, algorithm=algo)
            require_no_pallas_call(fn, keys)
            _require(exact_equal(fn(keys), oracle(np.asarray(keys))),
                     f"i: algorithm={algo}")
            self.report("i", f"sort u32 keys, algorithm={algo}", n, fn,
                        (keys,), lowering(fn, keys), "oracle")

    def one_card(self):
        self.keys_full()
        self.pairs_full()
        self.skewed_full()
        self.argsort_nan()
        self.bit_range()
        self.wide_keys()
        self.segmented()
        self.engines()

    # -- four cards -----------------------------------------------------

    def four_cards(self, n=1 << 30, n_exact=1 << 26, n_presorted=1 << 28):
        cards = len(jax.devices())
        _require(cards == 4, f"--cards 4 needs 4 devices, JAX has {cards}")
        # Auto axes: the checks slice the sharded outputs like any array
        mesh = jax.make_mesh((cards,), ("x",),
                             axis_types=(jax.sharding.AxisType.Auto,))
        shard = NamedSharding(mesh, P("x"))

        def bits(seed, size):
            return jax.jit(
                lambda: jax.random.bits(jax.random.key(seed), (size,),
                                        dtype=jnp.uint32),
                out_shardings=shard)()

        def iota(size):
            return jax.jit(lambda: jnp.arange(size, dtype=jnp.uint32),
                           out_shardings=shard)()

        sorter = make_global_sort(mesh, chunks=2)
        keys, vals = bits(11, n), iota(n)
        require_no_pallas_call(sorter, keys)
        _require(self.checks(sorter(keys), keys), "4: global sort keys")
        self.report("4", "make_global_sort(chunks=2) u32 keys", n, sorter,
                    (keys,), lowering(sorter, keys), "in-graph")
        require_no_pallas_call(sorter, keys, vals)
        gk, gv = sorter(keys, vals)
        _require(self.checks(gk, keys, gv, vals), "4: global sort pairs")
        del gk, gv
        self.report("4", "make_global_sort(chunks=2) u32 keys + arange",
                    n, sorter, (keys, vals), lowering(sorter, keys, vals),
                    "in-graph")
        del keys, vals

        # 64-bit keys with a skewed hi plane: tie quotas + lexicographic
        # splitters
        n64 = n // 4
        hi = jax.jit(lambda h: h % jnp.uint32(3),
                     out_shardings=shard)(bits(12, n64))
        lo = bits(13, n64)
        sorter64 = make_global_sort_planes(mesh, key_dtype="uint64")
        require_no_pallas_call(sorter64, (hi, lo))
        ohi, olo = sorter64((hi, lo))
        _require(self.checks((ohi, olo), (hi, lo)), "4: global sort u64")
        del ohi, olo
        self.report("4", "make_global_sort_planes u64, hi plane in [0, 3)",
                    n64, sorter64, ((hi, lo),), lowering(sorter64, (hi, lo)),
                    "in-graph")
        del hi, lo

        # presorted input at capacity_factor 1.0 overflows every
        # (src, dst) run: the all_gather fallback must run, and the
        # adaptive tier's factor bump proves it did
        pre = jax.jit(lambda: jnp.arange(n_presorted, dtype=jnp.uint32),
                      out_shardings=shard)()
        sorter_of = make_global_sort(mesh, capacity_factor=1.0,
                                     adaptive=True)
        _require(self.checks(sorter_of(pre), pre),
                 "4: presorted, all_gather fallback")
        _require(sorter_of._factors,
                 "4: presorted input did not take the all_gather fallback")
        print(json.dumps({"phase": "4", "what": "presorted, "
                          "capacity_factor=1.0: all_gather fallback taken",
                          "n": n_presorted, "ok": True,
                          "card": self.card}), flush=True)
        del pre

        # exact against one single-card tpusort.sort of the gathered input
        keys, vals = bits(14, n_exact), iota(n_exact)
        one = jax.devices()[0]
        k1 = jax.device_put(np.asarray(keys), one)
        want = np.asarray(tpusort.sort(k1))
        _require(exact_equal(sorter(keys), want), "4: exact keys vs 1 card")
        gk, gv = sorter(keys, vals)
        _require(exact_equal(gk, want)
                 and rows_bound(np.asarray(keys), gk, gv),
                 "4: exact pairs vs 1 card")
        hi = jax.jit(lambda h: h % jnp.uint32(3),
                     out_shardings=shard)(bits(15, n_exact))
        lo = bits(16, n_exact)
        w_hi, w_lo = tpusort.sort_planes(
            (jax.device_put(np.asarray(hi), one),
             jax.device_put(np.asarray(lo), one)), key_dtype="uint64")
        o_hi, o_lo = sorter64((hi, lo))
        _require(exact_equal(o_hi, np.asarray(w_hi))
                 and exact_equal(o_lo, np.asarray(w_lo)),
                 "4: exact u64 planes vs 1 card")
        print(json.dumps({"phase": "4", "what": "exact vs single-card "
                          "tpusort.sort: keys, pairs, u64 planes",
                          "n": n_exact, "ok": True, "card": self.card}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    require_gpu(jax.default_backend())
    device.enable_compile_cache()
    smoke = Smoke()
    if args.cards == 4:
        smoke.four_cards()
    else:
        smoke.one_card()
    print(smoke.card)
    print(json.dumps({"ok": True, "device": device.device_fields()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
