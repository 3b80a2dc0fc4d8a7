"""True multi-process (multi-host simulation) distributed sort.

Unlike the 8-virtual-device single-process mesh used elsewhere, this
spawns separate OS processes joined via ``jax.distributed.initialize``
with gloo CPU collectives — per-process addressable shards, collectives
spanning process boundaries — the same program shape as several hosts
with several cards each.  Workers verify local shard order, cross-process boundary
monotonicity, and global multiset checksums (tests/multiprocess_sim.py).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "multiprocess_sim.py")


@pytest.mark.slow
@pytest.mark.parametrize("pairs", [False, True])
def test_multiprocess_global_sort(pairs):
    env = dict(os.environ)
    # fresh processes must not inherit this test process's 8-device flag
    env.pop("XLA_FLAGS", None)
    args = [sys.executable, SCRIPT, "--nprocs", "2",
            "--devices-per-proc", "2", "--log2n", "12",
            "--port", "56311" if pairs else "56313"]
    if pairs:
        args.append("--pairs")
    res = subprocess.run(args, env=env, cwd=REPO, timeout=540,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "'ok': True" in res.stdout


@pytest.mark.slow
@pytest.mark.parametrize("entropy", [1, 2, 0])
def test_multiprocess_4x2_skew(entropy):
    """4 processes x 2 devices (8 shards spanning 4 OS processes) at
    2^16 keys across the entropy ladder: tie quotas and splitter
    selection must hold across REAL process boundaries, not just the
    single-process virtual mesh."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    args = [sys.executable, SCRIPT, "--nprocs", "4",
            "--devices-per-proc", "2", "--log2n", "16",
            "--entropy", str(entropy),
            "--port", str(56320 + entropy)]
    res = subprocess.run(args, env=env, cwd=REPO, timeout=540,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "'ok': True" in res.stdout
