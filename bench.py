"""Engine benchmark: keys/s or pairs/s of ``tpusort.sort`` on one card.

Workload mirrors the reference's benchmarks (2^28 uniform 32-bit keys,
``msb/src/test.cu:64``; the LSB driver's 2^28-item trials,
``lsb/sort.cu:87-131``).  Prints one JSON line per (engine, size, mode):
the median of ``--iters`` timed calls, each waited on with
``block_until_ready``, with every result checked in-graph against its
input, and the device it ran on.

    python bench.py                                   # 2^28 keys, auto
    python bench.py --log2n 21 24 28 --algorithm xla msd --pairs
    python bench.py --log2n 28 --algorithm xla msd --pairs --jit

``--jit`` times the call inside ``jax.jit``: the in-graph path a user's
jitted step (or a ``global_sort`` shard body) runs, without the host-side
tier chain of the radix engines.  A machine with no accelerator is an
error, not a CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, nargs="+", default=[28])
    ap.add_argument("--algorithm", nargs="+", default=["auto"])
    ap.add_argument("--pairs", action="store_true",
                    help="stable pairs with an enumerated uint32 payload")
    ap.add_argument("--unstable", action="store_true",
                    help="unstable pair semantics (reference MSB parity)")
    ap.add_argument("--jit", action="store_true",
                    help="time the call inside jax.jit")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import tpusort
    from tpusort.utils import device, timing
    from tpusort.utils.checks import sort_checks

    device.enable_compile_cache()
    if jax.default_backend() == "cpu":
        sys.exit("bench.py: no accelerator found (JAX backend is cpu)")
    dev = device.device_fields()
    card = device.gpu_name_and_power_limit()
    stable = args.pairs and not args.unstable
    checks = jax.jit(sort_checks, static_argnames="stable")

    for log2n in args.log2n:
        n = 1 << log2n
        keys = jax.random.bits(jax.random.key(log2n), (n,), dtype=jnp.uint32)
        vals = jnp.arange(n, dtype=jnp.uint32) if args.pairs else None
        for algo in args.algorithm:
            def call(k, v, algo=algo):
                if v is None:
                    return tpusort.sort(k, algorithm=algo)
                return tpusort.sort(k, v, algorithm=algo,
                                    stable=not args.unstable)

            fn = jax.jit(call) if args.jit else call
            times = timing.measure_all(fn, keys, vals, iters=args.iters)
            out = fn(keys, vals)
            if args.pairs:
                ok = checks(out[0], keys, out[1], vals, stable=stable)
            else:
                ok = checks(out, keys)
            del out
            dt = float(np.median(times))
            print(json.dumps({
                "metric": "pairs_per_s" if args.pairs else "keys_per_s",
                "value": n / dt,
                "algorithm": algo,
                "log2n": log2n,
                "mode": ("unstable_pairs" if args.unstable else
                         "stable_pairs") if args.pairs else "keys",
                "jit": args.jit,
                "median_s": dt,
                "times_s": times,
                "verified": bool(ok),
                "device": dev,
                "card": card,
                "jax": jax.__version__,
            }), flush=True)
            if not bool(ok):
                sys.exit(f"bench.py: wrong result for {algo} at 2^{log2n}")


if __name__ == "__main__":
    main()
