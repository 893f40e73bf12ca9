"""The CUDA upwind advection kernel (`csrc/hadv.cu`) and its launcher.

Replaces the TPU kernel `repro.kernels.hadv.hadv.hadv_pallas`. The plain
versions beside it are `ref.hadv_upwind` (passthrough) and
`ref.hadv_periodic`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.core.spans import spanned
from repro_torch.kernels import _build
from repro_torch.kernels.hadv.ref import DEFAULT_CFL


@spanned("nero.kernel.hadv")
def hadv_cuda(src: torch.Tensor, cfl: float = DEFAULT_CFL,
              tile: Optional[tiling.CudaTile] = None,
              periodic: bool = False) -> torch.Tensor:
    """Upwind advection of a contiguous CUDA stack `(planes, ny, nx)`,
    float32 or bfloat16. By default row 0 and column 0 of every plane pass
    through; `periodic=True` wraps them (row -1 is row ny - 1, column -1 is
    column nx - 1) and updates every point."""
    if src.dim() != 3:
        raise ValueError(f"hadv: src must be (planes, ny, nx), got "
                         f"{tuple(src.shape)}")
    planes, ny, nx = src.shape
    _build.check_operand("hadv", "src", src, src.shape, src.dtype)
    tile = tile or tiling.hadv_tile(ny, nx, src.element_size())
    out = torch.empty_like(src)
    lib = _build.load()
    with torch.cuda.device(src.device):
        err = lib.nero_hadv(src.data_ptr(), out.data_ptr(), planes, ny, nx,
                            cfl, tile.ty, tile.tx, int(periodic),
                            int(src.dtype == torch.bfloat16),
                            _build.stream_of(src))
    _build.check(err, "hadv")
    _build.LAUNCHES["hadv"] += 1
    return out
