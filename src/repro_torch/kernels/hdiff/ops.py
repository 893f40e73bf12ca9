"""Public hdiff entry point: the tensor's device decides what runs.

A CPU tensor takes the plain version (`ref.hdiff`, `ref.hdiff_kstep`); a
CUDA tensor launches the CUDA kernel (`hdiff.hdiff_cuda`,
`hdiff.hdiff_kstep_cuda`) or raises. There is no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.kernels.hdiff import ref as _ref
from repro_torch.kernels.hdiff.hdiff import hdiff_cuda, hdiff_kstep_cuda

HALO = 2   # the compound stencil's one-sided reach in y and x


def hdiff(src: torch.Tensor, coeff: float = _ref.DEFAULT_COEFF,
          tile: Optional[tiling.CudaTile] = None) -> torch.Tensor:
    """Compound hdiff of a `(planes, ny, nx)` stack; the ring passes
    through."""
    if src.device.type == "cpu":
        return _ref.hdiff(src, coeff=coeff)
    return hdiff_cuda(src, coeff=coeff, tile=tile)


def hdiff_kstep(src: torch.Tensor, coeff: float = _ref.DEFAULT_COEFF,
                k: int = 1,
                tile: Optional[tiling.CudaTile] = None) -> torch.Tensor:
    """`k` compound hdiff steps of a `(planes, ny, nx)` stack in one launch
    (`tiling.hdiff_launches(k)` for more than `tiling.HDIFF_MAX_K`), each
    rounded through the storage dtype; the ring passes through."""
    if src.device.type == "cpu":
        return _ref.hdiff_kstep(src, coeff=coeff, k=k)
    return hdiff_kstep_cuda(src, coeff=coeff, k_steps=k, tile=tile)
