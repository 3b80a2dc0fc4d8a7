"""Tuning-configuration system.

Analog of the reference's two config layers:

* CUB's per-SM chained tuning policies — digit width / items-per-thread
  tables selected by hardware generation
  (``lsb/cub/cub/device/dispatch/dispatch_radix_sort.cuh:467-744``), and
* the MSB project's compile-time ``RadixSortConfig<KEY_SIZE, VALUE_SIZE>``
  TPB/KPT tables plus runtime local-sort kernel registries
  (``msb/src/sort/gpu_sort_config.h:146-336``).

Here the tunables are the engine choice for ``algorithm="auto"``, the MSD
planner geometry (tile size K, radix R, pass-1 padded capacity S1, leaf
segment bound) and the delegation thresholds.  Configs are keyed by
(key_bits, has_values, platform); ``SortConfig.plan_kwargs()`` feeds
``ops.msd.plan_msd`` directly, so changing a registered config changes the
compiled pass plan (pinned by ``tests/test_configs.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["SortConfig", "get_config", "register_config"]


@dataclass(frozen=True)
class SortConfig:
    # --- MSD/LSD engine plan geometry (ops.msd.plan_msd kwargs; the
    #     TPB/KPT analog) ---
    tile_elems: int = 1 << 14      # K: elements per tile
    radix: int = 32                # R: runs per tile (digit fan-out)
    s1: Optional[int] = None       # pass-1 padded run capacity (None = auto)
    leaf_max: Optional[int] = None # max final segment size (None = auto)
    min_n: int = 1 << 16           # below this the engine delegates
    # --- small-problem engine bound (analog of CUB InvokeSingleTile,
    #     dispatch_radix_sort.cuh:834-875) ---
    small_n_threshold: int = 1 << 14
    # --- algorithm auto-selection ---
    default_algorithm: str = "xla"

    def plan_kwargs(self) -> dict:
        """The ``plan_msd`` keyword arguments this config pins."""
        kw = dict(k=self.tile_elems, r=self.radix, min_n=self.min_n)
        if self.s1 is not None:
            kw["s1"] = self.s1
        if self.leaf_max is not None:
            kw["leaf_max"] = self.leaf_max
        return kw


_REGISTRY: Dict[Tuple[int, bool, str], SortConfig] = {}


def register_config(key_bits: int, has_values: bool, platform: str, cfg: SortConfig):
    _REGISTRY[(key_bits, has_values, platform)] = cfg


def get_config(
    key_bits: int, has_values: bool, platform: Optional[str] = None
) -> SortConfig:
    if platform is None:
        import jax

        platform = jax.default_backend()
    for key in (
        (key_bits, has_values, platform),
        (key_bits, has_values, "*"),
    ):
        if key in _REGISTRY:
            return _REGISTRY[key]
    return SortConfig()


# GPU: ``auto`` is XLA's own sort, which XLA hands to CUB's radix sort
# where the operand shape allows.  No engine here has yet beaten it on the
# card, so the MSD geometry fields keep their defaults (used only when a
# caller names algorithm="msd").  CPU (test) configs use small tiles and a
# low min_n so the full pass pipelines execute at CI problem sizes through
# the public API.
_GPU = SortConfig(default_algorithm="xla")
_CPU = SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096,
                  small_n_threshold=2048)
for _bits in (32, 64):
    for _hv in (False, True):
        register_config(_bits, _hv, "gpu", _GPU)
        register_config(_bits, _hv, "cpu", _CPU)
