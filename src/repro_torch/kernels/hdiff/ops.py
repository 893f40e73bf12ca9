"""Public hdiff entry point: the tensor's device decides what runs.

A CPU tensor takes the plain version (`ref.hdiff`, `ref.hdiff_periodic`,
`ref.hdiff_kstep`); a CUDA tensor launches the CUDA kernel (`hdiff.hdiff_cuda`,
`hdiff.hdiff_kstep_cuda`) or raises. There is no fallback.

`plan_tile` / `resolve_tile` are the JAX package's window planner: the
analytic model's (1, ty, nx) window, tuned under `hwspec.default_spec()`
and snapped to a divisor of ny, which `ExecutionPlan.report()["model"]`
estimates. The launch does not take it: the stream's tile is
`tiling.hdiff_kstep_tile` (its strip rule measured within 1.6% of the best
tile on the H100), or the tile `compile(tune="measure")` timed fastest.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import autotune, tiling
from repro_torch.kernels.hdiff import ref as _ref
from repro_torch.kernels.hdiff.hdiff import hdiff_cuda, hdiff_kstep_cuda
from repro_torch.weather.fields import dtype_name

HALO = 2   # the compound stencil's one-sided reach in y and x


def plan_tile(grid_shape, dtype) -> int:
    """The model's y-window (every space holds a 1-point window, so the
    tuner always finds one)."""
    tuned = autotune.tune_named("hdiff", grid_shape, dtype)
    return tiling.snap_to_divisor(tuned.plan.tile[1], grid_shape[1], lo=2)


def resolve_tile(grid_shape, dtype) -> tiling.TilePlan:
    """The model's window as a `TilePlan`: one plane, `plan_tile`'s rows,
    the whole x extent."""
    return tiling.TilePlan(op=autotune.get_op("hdiff"),
                           grid_shape=tuple(int(g) for g in grid_shape),
                           tile=(1, plan_tile(grid_shape, dtype),
                                 int(grid_shape[2])),
                           dtype=dtype_name(dtype))


def hdiff(src: torch.Tensor, coeff: float = _ref.DEFAULT_COEFF,
          tile: Optional[tiling.CudaTile] = None,
          periodic: bool = False) -> torch.Tensor:
    """Compound hdiff of a `(planes, ny, nx)` stack; the ring passes
    through, or with `periodic=True` wraps to the far side of the plane."""
    if src.device.type == "cpu":
        plain = _ref.hdiff_periodic if periodic else _ref.hdiff
        return plain(src, coeff=coeff)
    return hdiff_cuda(src, coeff=coeff, tile=tile, periodic=periodic)


def hdiff_kstep(src: torch.Tensor, coeff: float = _ref.DEFAULT_COEFF,
                k: int = 1,
                tile: Optional[tiling.CudaTile] = None) -> torch.Tensor:
    """`k` compound hdiff steps of a `(planes, ny, nx)` stack in one launch
    (`tiling.hdiff_launches(k)` for more than `tiling.HDIFF_MAX_K`), each
    rounded through the storage dtype; the ring passes through."""
    if src.device.type == "cpu":
        return _ref.hdiff_kstep(src, coeff=coeff, k=k)
    return hdiff_kstep_cuda(src, coeff=coeff, k_steps=k, tile=tile)
