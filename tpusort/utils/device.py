"""Facts about the device that the program derives instead of hard-coding,
and the one place that chooses the persistent compile-cache directory."""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import jax

__all__ = [
    "device_bytes_limit",
    "cond_fallback_fits",
    "compile_cache_dir",
    "enable_compile_cache",
    "device_fields",
    "gpu_name_and_power_limit",
]

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Device bytes per element and operand that an in-graph ``lax.cond``
# overflow fallback needs: the MSD pass buffers in and out (padded ~1.5x,
# plus the per-pass sort key) and, reserved beside them, the fallback
# sort's masked copy, carried planes and workspace.
COND_BYTES_PER_ELEM_OP = 32


def device_bytes_limit() -> Optional[int]:
    """Bytes the allocator may hand out on the first local device, or None
    where the backend reports no limit (the CPU reports no memory stats)."""
    stats = jax.local_devices()[0].memory_stats()
    if not stats:
        return None
    return stats.get("bytes_limit")


def cond_fallback_fits(n: int, n_ops: int,
                       bytes_limit: Optional[int] = None) -> bool:
    """Whether an ``n``-element sort of ``n_ops`` uint32 operands can carry
    its overflow fallback in-graph.  Above this the host owns the
    fallback decision (flag mode), so no fallback workspace is reserved."""
    if bytes_limit is None:
        bytes_limit = device_bytes_limit()
    if bytes_limit is None:
        return True
    return n * n_ops * COND_BYTES_PER_ELEM_OP <= bytes_limit


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``.
    The path is part of the cache key, so it never depends on a temp name,
    a pid or the time."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`.
    Call before the first compilation; returns the directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path


def device_fields() -> dict:
    """The device every measurement is reported against."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them (a card
    set below its maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
