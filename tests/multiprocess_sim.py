"""Multi-process (multi-host simulation) distributed sort driver.

The reference is single-device; the scaling axis (SURVEY §2.3) spans
hosts.  This simulates several hosts at the JAX level on one CPU machine:
N OS processes, each owning K CPU devices, joined through
``jax.distributed.initialize`` into one global runtime with cross-process
collectives (gloo) — the same program shape as several hosts with several
cards each (per-process addressable shards, global mesh, psum/all_gather/
all_to_all spanning processes).

Driver mode (default) spawns the workers and aggregates their verdicts:

    python tests/multiprocess_sim.py --nprocs 2 --devices-per-proc 2

Worker mode (spawned with --pid) runs one process's share and verifies:
  * every addressable output shard is locally sorted,
  * shard boundaries are non-decreasing ACROSS processes (allgather),
  * the global key multiset is preserved (psum of u64-wide checksums).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def worker(pid: int, nprocs: int, port: int, n: int, k: int,
           pairs: bool, entropy: int = 1) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpusort.parallel.global_sort import make_global_sort

    devs = jax.devices()
    assert len(devs) == nprocs * k, (len(devs), nprocs, k)
    assert len(jax.local_devices()) == k
    mesh = jax.make_mesh((nprocs * k,), ("x",))
    sharding = NamedSharding(mesh, P("x"))

    # each process contributes only ITS shards (true multi-host dataflow:
    # no process ever holds the global array — the per-shard seeded stream
    # generates exactly [lo, hi), O(shard) memory and work)
    def _mk(idx):
        lo, hi = idx[0].start or 0, idx[0].stop or n
        rng = np.random.default_rng((12345, lo))
        out = rng.integers(0, 1 << 32, hi - lo,
                           dtype=np.uint64).astype(np.uint32)
        # entropy-AND ladder (the reference's skew stressor,
        # msb/tests/data_gen.h:44-76): level e ANDs e draws; level 0 is
        # constant zeros — exercises the tie quotas across processes
        for _ in range(entropy - 1):
            out &= rng.integers(0, 1 << 32, hi - lo,
                                dtype=np.uint64).astype(np.uint32)
        if entropy == 0:
            out[:] = 0
        return out

    keys = jax.make_array_from_callback((n,), sharding, _mk)
    vals = jax.make_array_from_callback(
        (n,), sharding,
        lambda idx: np.arange(idx[0].start or 0, idx[0].stop or n,
                              dtype=np.uint32))

    sorter = make_global_sort(mesh)
    if pairs:
        out_keys, out_vals = sorter(keys, vals)
    else:
        out_keys = sorter(keys)

    # 1) local shard sortedness
    locs = sorted(out_keys.addressable_shards, key=lambda s: s.index[0].start)
    for s in locs:
        a = np.asarray(s.data)
        assert np.all(a[:-1] <= a[1:]), f"shard {s.index} unsorted"

    # 2) cross-process boundary order + 3) global multiset checksums
    #    (+ 4, pairs: (key, value)-BINDING checksum — a shuffle that
    #    permutes values independently of keys must fail, not pass on
    #    keys-only evidence)
    def csum(x):
        x = x.astype(jnp.uint32)
        s1 = jax.lax.psum(jnp.sum(x, dtype=jnp.uint32), "x")
        s2 = jax.lax.psum(jnp.sum(x ^ (x >> 7), dtype=jnp.uint32), "x")
        return s1, s2

    def pair_csum(kx, vx):
        h = kx.astype(jnp.uint32) ^ (
            vx.astype(jnp.uint32) * jnp.uint32(2654435761))
        return csum(h)

    def _check(kin, kout):
        lo = kout[:1].astype(jnp.uint32)
        hi = kout[-1:].astype(jnp.uint32)
        b = jax.lax.all_gather(jnp.concatenate([lo, hi]), "x").reshape(-1)
        mono = jnp.all(b[:-1] <= b[1:])
        return mono, csum(kin), csum(kout)

    spec = P("x")
    mono, cin, cout = jax.jit(
        jax.shard_map(_check, mesh=mesh, in_specs=(spec, spec),
                      out_specs=(P(),) * 3, check_vma=False)
    )(keys, out_keys)
    assert bool(mono), "shard boundaries decrease across processes"
    assert np.asarray(cin) .tolist() == np.asarray(cout).tolist(), \
        "global key multiset changed"
    if pairs:
        pin, pout = jax.jit(
            jax.shard_map(
                lambda ki, vi, ko, vo: (pair_csum(ki, vi),
                                        pair_csum(ko, vo)),
                mesh=mesh, in_specs=(spec,) * 4, out_specs=(P(),) * 2,
                check_vma=False)
        )(keys, vals, out_keys, out_vals)
        assert np.asarray(pin).tolist() == np.asarray(pout).tolist(), \
            "pair (key, value) binding changed"
    print(f"worker {pid}: OK ({len(locs)} shards, n={n})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--port", type=int, default=56297)
    ap.add_argument("--log2n", type=int, default=13)
    ap.add_argument("--pairs", action="store_true")
    ap.add_argument("--entropy", type=int, default=1)
    args = ap.parse_args()
    n = 1 << args.log2n

    if args.pid is not None:
        worker(args.pid, args.nprocs, args.port, n,
               args.devices_per_proc, args.pairs, args.entropy)
        return 0

    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    env["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count="
        f"{args.devices_per_proc}"
    ).strip()
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--pid", str(i), "--nprocs", str(args.nprocs),
             "--devices-per-proc", str(args.devices_per_proc),
             "--port", str(args.port), "--log2n", str(args.log2n),
             "--entropy", str(args.entropy)]
            + (["--pairs"] if args.pairs else []),
            env=env, cwd=REPO,
        )
        for i in range(args.nprocs)
    ]
    # reap with cleanup: if one worker dies, its peers block in gloo
    # collectives forever — poll so a failure is noticed immediately, then
    # kill the EXACT child PIDs we spawned (never by pattern) so no orphan
    # holds the coordinator port for the next run
    import time

    deadline = time.time() + 600
    rc = {}
    try:
        while len(rc) < len(procs) and time.time() < deadline:
            for i, p in enumerate(procs):
                if i not in rc and p.poll() is not None:
                    rc[i] = p.returncode
            if any(r != 0 for r in rc.values()):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = len(rc) == len(procs) and all(r == 0 for r in rc.values())
    print({"metric": "multiprocess_sim", "nprocs": args.nprocs,
           "devices": args.nprocs * args.devices_per_proc,
           "n": n, "ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
