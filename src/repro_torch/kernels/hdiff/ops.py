"""Public hdiff entry point: the tensor's device decides what runs.

A CPU tensor takes the plain version (`ref.hdiff`); a CUDA tensor launches
the CUDA kernel (`hdiff.hdiff_cuda`) or raises. There is no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.kernels.hdiff import ref as _ref
from repro_torch.kernels.hdiff.hdiff import hdiff_cuda

HALO = 2   # the compound stencil's one-sided reach in y and x


def hdiff(src: torch.Tensor, coeff: float = _ref.DEFAULT_COEFF,
          tile: Optional[tiling.CudaTile] = None) -> torch.Tensor:
    """Compound hdiff of a `(planes, ny, nx)` stack; the ring passes
    through."""
    if src.device.type == "cpu":
        return _ref.hdiff(src, coeff=coeff)
    return hdiff_cuda(src, coeff=coeff, tile=tile)
