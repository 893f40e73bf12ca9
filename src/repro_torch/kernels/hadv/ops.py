"""Public upwind-advection entry point: the tensor's device decides.

A CPU tensor takes the plain version (`ref.hadv_upwind`, or
`ref.hadv_periodic`); a CUDA tensor launches the CUDA kernel
(`hadv.hadv_cuda`) or raises. There is no
fallback.

`plan_tile` / `resolve_tile` are the JAX package's window planner: the
analytic model's (1, ty, nx) window, tuned under `hwspec.default_spec()`,
which `ExecutionPlan.report()["model"]` estimates. The launch takes
`tiling.hadv_tile` (or the tile `compile(tune="measure")` timed fastest),
not this window.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import autotune, tiling
from repro_torch.kernels.hadv import ref as _ref
from repro_torch.kernels.hadv.hadv import hadv_cuda
from repro_torch.weather.fields import dtype_name

HALO = 1   # one-sided (low-side) reach in y and x


def plan_tile(grid_shape, dtype) -> int:
    """The model's y-window, snapped to a divisor of ny."""
    tuned = autotune.tune_named("hadv_upwind", grid_shape, dtype)
    return tiling.snap_to_divisor(tuned.plan.tile[1], grid_shape[1], lo=1)


def resolve_tile(grid_shape, dtype) -> tiling.TilePlan:
    """The model's window as a `TilePlan`: one plane, `plan_tile`'s rows,
    the whole x extent."""
    return tiling.TilePlan(op=autotune.get_op("hadv_upwind"),
                           grid_shape=tuple(int(g) for g in grid_shape),
                           tile=(1, plan_tile(grid_shape, dtype),
                                 int(grid_shape[2])),
                           dtype=dtype_name(dtype))


def hadv_upwind(src: torch.Tensor, cfl: float = _ref.DEFAULT_CFL,
                tile: Optional[tiling.CudaTile] = None,
                periodic: bool = False) -> torch.Tensor:
    """Upwind advection of a `(planes, ny, nx)` stack; row 0 and column 0
    pass through, or with `periodic=True` wrap to row ny - 1 and column
    nx - 1."""
    if src.device.type == "cpu":
        plain = _ref.hadv_periodic if periodic else _ref.hadv_upwind
        return plain(src, cfl=cfl)
    return hadv_cuda(src, cfl=cfl, tile=tile, periodic=periodic)
