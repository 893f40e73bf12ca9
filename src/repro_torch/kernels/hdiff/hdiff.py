"""The CUDA compound hdiff kernel (`csrc/hdiff.cu`) and its launcher.

Replaces the TPU kernel `repro.kernels.hdiff.hdiff.hdiff_pallas`. The plain
version beside it is `ref.hdiff`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels.hdiff.ref import DEFAULT_COEFF


def hdiff_cuda(src: torch.Tensor, coeff: float = DEFAULT_COEFF,
               tile: Optional[tiling.CudaTile] = None) -> torch.Tensor:
    """Compound hdiff of a contiguous CUDA stack `(planes, ny, nx)`, float32
    or bfloat16; the 2-wide ring of every plane passes through."""
    if src.dim() != 3:
        raise ValueError(f"hdiff: src must be (planes, ny, nx), got "
                         f"{tuple(src.shape)}")
    planes, ny, nx = src.shape
    _build.check_operand("hdiff", "src", src, src.shape, src.dtype)
    tile = tile or tiling.hdiff_tile(ny, nx)
    out = torch.empty_like(src)
    lib = _build.load()
    with torch.cuda.device(src.device):
        err = lib.nero_hdiff(src.data_ptr(), out.data_ptr(), planes, ny, nx,
                             coeff, tile.ty, tile.tx,
                             int(src.dtype == torch.bfloat16),
                             _build.stream_of(src))
    _build.check(err, "hdiff")
    _build.LAUNCHES["hdiff"] += 1
    return out
