"""Memory-hierarchy views of the shipped hardware specs.

A port of `repro.core.hierarchy`: `Hierarchy`, `MemoryLevel` and
`dtype_bytes` come from `core/hwspec.py`; `tpu_v5e()` is the JAX package's
default planning target and `h100_sxm()` the port's. The module constants
are the JAX package's historical names, read from `specs/tpu_v5e.json` as
there (no literal here): they describe the TPU v5e, never the card.
`VPU_LANES`, the TPU's (sublane, lane) alignment, is the one the port
reads: `tiling.TilePlan.lane_aligned` keeps it for candidate order, so both
packages rank a tile space the same way. New code takes a
`hwspec.HardwareSpec` instead.
"""

from __future__ import annotations

import warnings
from typing import Dict

from repro_torch.core import hwspec
from repro_torch.core.hwspec import (  # noqa: F401  (re-exported API)
    Hierarchy,
    MemoryLevel,
    dtype_bytes,
)

_V5E = hwspec.load_spec("tpu_v5e")

# per-chip constants of the TPU v5e, from its spec
PEAK_BF16_FLOPS = _V5E.peak_flops["bfloat16"]
PEAK_FP32_FLOPS = _V5E.peak_flops["float32"]
HBM_BYTES = _V5E.main.capacity_bytes
HBM_BW = _V5E.main.bandwidth_bytes_per_s
ICI_BW_PER_LINK = _V5E.collective.bandwidth_bytes_per_s
ICI_LINKS = _V5E.collective.links
VMEM_BYTES = _V5E.near_physical_bytes   # physical VMEM per core
VMEM_USABLE = _V5E.near.capacity_bytes  # budget the planner may claim
VMEM_BW = _V5E.near.bandwidth_bytes_per_s
VREG_BYTES = _V5E.reg.capacity_bytes
MXU_TILE = _V5E.layout["mxu_tile"]
VPU_LANES = _V5E.layout["vpu_lanes"]

# energy model (pJ a byte moved, pJ a flop)
ENERGY_PJ_PER_BYTE: Dict[str, float] = {
    "hbm": _V5E.main.energy_pj_per_byte,
    "vmem": _V5E.near.energy_pj_per_byte,
    "vreg": _V5E.reg.energy_pj_per_byte,
    "ici": _V5E.collective.energy_pj_per_byte,
    "host": _V5E.host_energy_pj_per_byte,
}
ENERGY_PJ_PER_FLOP_BF16 = _V5E.energy_pj_per_flop
CHIP_IDLE_WATTS = _V5E.idle_watts
CHIP_PEAK_WATTS = _V5E.peak_watts


def tpu_v5e() -> Hierarchy:
    return _V5E.hierarchy()


def h100_sxm() -> Hierarchy:
    return hwspec.load_spec("h100_sxm").hierarchy()


# The paper's POWER9 baseline: the old names resolve through the module's
# `__getattr__` and warn; `hwspec.load_spec("power9")` is the spec.
_DEPRECATED = {
    "POWER9_PEAK_FLOPS":
        lambda: hwspec.load_spec("power9").peak_flops["float32"],
    "POWER9_DRAM_BW":
        lambda: hwspec.load_spec("power9").main.bandwidth_bytes_per_s,
}


def __getattr__(name: str):
    if name in _DEPRECATED:
        warnings.warn(
            f"repro_torch.core.hierarchy.{name} is deprecated; load the "
            f"'power9' hardware spec via "
            f"repro_torch.core.hwspec.load_spec('power9') instead",
            DeprecationWarning, stacklevel=2)
        return _DEPRECATED[name]()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
