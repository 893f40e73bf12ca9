"""Public upwind-advection entry point: the tensor's device decides.

A CPU tensor takes the plain version (`ref.hadv_upwind`, or
`ref.hadv_periodic`); a CUDA tensor launches the CUDA kernel
(`hadv.hadv_cuda`) or raises. There is no
fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.kernels.hadv import ref as _ref
from repro_torch.kernels.hadv.hadv import hadv_cuda

HALO = 1   # one-sided (low-side) reach in y and x


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
