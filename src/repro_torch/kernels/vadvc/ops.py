"""Public vadvc entry point: the tensor's device decides what runs.

A CPU tensor takes the plain version (`ref.vadvc`); a CUDA tensor launches
the CUDA kernel (`vadvc.vadvc_cuda`) or raises. There is no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.kernels.vadvc import ref as _ref
from repro_torch.kernels.vadvc.vadvc import vadvc_cuda


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
