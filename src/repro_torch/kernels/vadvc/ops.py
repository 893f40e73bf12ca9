"""Public vadvc entry point: the tensor's device decides what runs.

A CPU tensor takes the plain version (`ref.vadvc`); a CUDA tensor launches
the CUDA kernel (`vadvc.vadvc_cuda`) or raises. There is no fallback.

`plan_tile` / `resolve_tile` are the JAX package's window planner: the
analytic model's (nz, tj, ti) window, tuned under `hwspec.default_spec()`
and snapped to divisors, which `ExecutionPlan.report()["model"]`
estimates; where nz levels leave no window in the spec's near memory, a
row of `tiling.VADVC_COLS` columns. The launch takes `tiling.vadvc_tile`
(or the tile `compile(tune="measure")` timed fastest), not this window.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import autotune, tiling
from repro_torch.kernels.vadvc import ref as _ref
from repro_torch.kernels.vadvc.vadvc import vadvc_cuda
from repro_torch.weather.fields import dtype_name


def plan_tile(grid_shape, dtype):
    """The model's (tj, ti) window, each snapped to a divisor."""
    nz, ny, nx = grid_shape
    _, tj, ti = autotune.tuned_window(autotune.get_op("vadvc"), grid_shape,
                                      dtype, (nz, 1, tiling.VADVC_COLS))
    return (tiling.snap_to_divisor(tj, ny, lo=1),
            tiling.snap_to_divisor(ti, nx, lo=1))


def resolve_tile(grid_shape, dtype) -> tiling.TilePlan:
    """The model's window as a `TilePlan` (z whole: the sweep is
    sequential in z)."""
    tj, ti = plan_tile(grid_shape, dtype)
    return tiling.TilePlan(op=autotune.get_op("vadvc"),
                           grid_shape=tuple(int(g) for g in grid_shape),
                           tile=(int(grid_shape[0]), tj, ti),
                           dtype=dtype_name(dtype))


def vadvc(u_stage: torch.Tensor, wcon: torch.Tensor, u_pos: torch.Tensor,
          utens: torch.Tensor, utens_stage: torch.Tensor,
          tile: Optional[tiling.CudaTile] = None) -> torch.Tensor:
    """Updated stage tendency of `(..., nz, ny, nx)` fields; `wcon` is
    staggered, `(..., nz, ny, nx + 1)`, or periodic, `(..., nz, ny, nx)`,
    its leading axes a prefix of the fields' (shared by the fields under
    it)."""
    if u_stage.device.type == "cpu":
        extra = u_stage.dim() - wcon.dim()
        wb = wcon.reshape(wcon.shape[:-3] + (1,) * extra + wcon.shape[-3:])
        return _ref.vadvc(u_stage, wb, u_pos, utens, utens_stage)
    return vadvc_cuda(u_stage, wcon, u_pos, utens, utens_stage, tile=tile)
