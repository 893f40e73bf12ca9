"""The CUDA compound hdiff kernel (`csrc/hdiff.cu`: one row-streaming
routine, one step or k steps a launch) and its launchers.

Replaces the TPU kernels `repro.kernels.hdiff.hdiff.hdiff_pallas` and
`hdiff_kstep_pallas`. The plain versions beside them are `ref.hdiff`,
`ref.hdiff_periodic` and `ref.hdiff_kstep`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.core.spans import spanned
from repro_torch.kernels import _build
from repro_torch.kernels.hdiff.ref import DEFAULT_COEFF


@spanned("nero.kernel.hdiff")
def hdiff_cuda(src: torch.Tensor, coeff: float = DEFAULT_COEFF,
               tile: Optional[tiling.CudaTile] = None,
               periodic: bool = False) -> torch.Tensor:
    """Compound hdiff of a contiguous CUDA stack `(planes, ny, nx)`, float32
    or bfloat16. By default the 2-wide ring of every plane passes through;
    `periodic=True` wraps it (row j outside [0, ny) is row j mod ny, column
    i outside [0, nx) column i mod nx; planes of at least 2 x 2) and
    computes every point."""
    if src.dim() != 3:
        raise ValueError(f"hdiff: src must be (planes, ny, nx), got "
                         f"{tuple(src.shape)}")
    planes, ny, nx = src.shape
    _build.check_operand("hdiff", "src", src, src.shape, src.dtype)
    tile = tile or tiling.hdiff_tile(ny, nx, periodic=periodic)
    out = torch.empty_like(src)
    lib = _build.load()
    with torch.cuda.device(src.device):
        err = lib.nero_hdiff(src.data_ptr(), out.data_ptr(), planes, ny, nx,
                             coeff, tile.ty, tile.tx, tile.threads,
                             int(periodic), int(src.dtype == torch.bfloat16),
                             _build.stream_of(src))
    _build.check(err, "hdiff")
    _build.LAUNCHES["hdiff"] += 1
    return out


@spanned("nero.kernel.hdiff_kstep")
def hdiff_kstep_cuda(src: torch.Tensor, coeff: float = DEFAULT_COEFF,
                     k_steps: int = 1,
                     tile: Optional[tiling.CudaTile] = None) -> torch.Tensor:
    """`k_steps` compound hdiff steps of a contiguous CUDA stack `(planes,
    ny, nx)`, float32 or bfloat16, in one launch, or for more than
    `tiling.HDIFF_MAX_K` steps in `tiling.hdiff_launches(k_steps)`: every
    step rounds through the storage dtype and passes the 2-wide ring of
    every plane through, so the split changes no bit."""
    if src.dim() != 3:
        raise ValueError(f"hdiff k-step: src must be (planes, ny, nx), got "
                         f"{tuple(src.shape)}")
    launches = tiling.hdiff_launches(k_steps)
    planes, ny, nx = src.shape
    _build.check_operand("hdiff k-step", "src", src, src.shape, src.dtype)
    tile = tile or tiling.hdiff_kstep_tile(ny, nx, k_steps)
    lib = _build.load()
    out = src
    for k in launches:
        src, out = out, torch.empty_like(src)
        with torch.cuda.device(src.device):
            err = lib.nero_hdiff_kstep(
                src.data_ptr(), out.data_ptr(), planes, ny, nx, coeff,
                tile.ty, tile.tx, tile.threads, k,
                int(src.dtype == torch.bfloat16), _build.stream_of(src))
        _build.check(err, "hdiff k-step")
        _build.LAUNCHES["hdiff_kstep"] += 1
    return out
