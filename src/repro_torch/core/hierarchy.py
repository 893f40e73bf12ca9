"""Memory-hierarchy views of the shipped hardware specs.

A port of `repro.core.hierarchy`: `Hierarchy`, `MemoryLevel` and
`dtype_bytes` come from `core/hwspec.py`; `tpu_v5e()` is the JAX package's
default planning target and `h100_sxm()` the port's. `VPU_LANES` is the
TPU's (sublane, lane) alignment, which `tiling.TilePlan.lane_aligned` keeps
for candidate order, so both packages rank a tile space the same way.
"""

from __future__ import annotations

from repro_torch.core import hwspec
from repro_torch.core.hwspec import (  # noqa: F401  (re-exported API)
    Hierarchy,
    MemoryLevel,
    dtype_bytes,
)

# `layout.vpu_lanes` of `specs/tpu_v5e.json` (tests hold the two equal).
VPU_LANES = (8, 128)


def tpu_v5e() -> Hierarchy:
    return hwspec.load_spec("tpu_v5e").hierarchy()


def h100_sxm() -> Hierarchy:
    return hwspec.load_spec("h100_sxm").hierarchy()
