"""The CUDA fused dycore kernel (`csrc/dycore_fused.cu`) and its launcher.

Replaces the TPU kernels `fused_dycore_whole_state_pallas` and
`fused_dycore_pallas` (`repro.kernels.dycore_fused.fused`): one launch covers
every field of a field-stacked state; the per-field variant is the same
kernel at nf = 1. The plain version beside it is `ref.fused_step_ref`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import tiling
from repro_torch.core.spans import spanned
from repro_torch.kernels import _build
from repro_torch.kernels.dycore_fused.ref import DEFAULT_COEFF, DEFAULT_DT


def scratch_shapes(batch: int, nf: int, nz: int, ny: int, nx: int,
                   tile: tiling.CudaTile) -> Tuple[tuple, tuple]:
    """The kernel's two fp32 scratch buffers, `(ccol, dcol)`: the backward
    sweep's coefficient once a cluster of `tile.cluster` field blocks (it
    depends on w alone) and D once a block, `nz - 1` levels of the tile's
    haloed columns each."""
    tiles = batch * -(-ny // tile.ty) * -(-nx // tile.tx)
    return ((tiles * nf // tile.cluster, nz - 1, tile.threads),
            (tiles * nf, nz - 1, tile.threads))


@spanned("nero.kernel.dycore_fused")
def fused_dycore_cuda(fs: torch.Tensor, w: torch.Tensor, utens: torch.Tensor,
                      utens_stage: torch.Tensor, *,
                      coeff: float = DEFAULT_COEFF, dt: float = DEFAULT_DT,
                      tile: Optional[tiling.CudaTile] = None):
    """One dycore step of field-stacked `fs`, `utens`, `utens_stage`
    `(..., nf, nz, ny, nx)`, doubly periodic in (y, x); `w` is the
    pre-combined staggered velocity `wcon_i + wcon_{i+1}`, `(..., nz, ny,
    nx)`, shared by every field. All contiguous CUDA tensors of one dtype
    (float32 or bfloat16). `tile` defaults to `tiling.dycore_tile` for these
    fields; its cluster must divide nf. Returns `(f_new, stage)` shaped like
    `fs`."""
    if fs.dim() < 4:
        raise ValueError(f"fused dycore: fs must be (..., nf, nz, ny, nx), "
                         f"got {tuple(fs.shape)}")
    nf, nz, ny, nx = fs.shape[-4:]
    if nz < 2:
        raise ValueError(f"fused dycore: nz={nz} must be >= 2 (staggered "
                         f"vertical sweep)")
    batch = math.prod(fs.shape[:-4])
    for name, t in (("fs", fs), ("utens", utens),
                    ("utens_stage", utens_stage)):
        _build.check_operand("fused dycore", name, t, fs.shape, fs.dtype)
    _build.check_operand("fused dycore", "w", w,
                         tuple(fs.shape[:-4]) + (nz, ny, nx), fs.dtype)
    tile = tile or tiling.dycore_tile(ny, nx, nz=nz, nf=nf)
    if nf % tile.cluster:
        raise ValueError(f"fused dycore: a cluster of {tile.cluster} field "
                         f"blocks does not divide nf={nf}")
    f_new = torch.empty_like(fs)
    stage = torch.empty_like(fs)
    ccol, dcol = (torch.empty(shape, dtype=torch.float32, device=fs.device)
                  for shape in scratch_shapes(batch, nf, nz, ny, nx, tile))
    lib = _build.load()
    with torch.cuda.device(fs.device):
        err = lib.nero_dycore_fused(
            fs.data_ptr(), w.data_ptr(), utens.data_ptr(),
            utens_stage.data_ptr(), f_new.data_ptr(), stage.data_ptr(),
            ccol.data_ptr(), dcol.data_ptr(), batch, nf, tile.cluster, nz,
            ny, nx, dt, coeff, tile.ty, tile.tx,
            int(fs.dtype == torch.bfloat16), _build.stream_of(fs))
    _build.check(err, "fused dycore")
    _build.LAUNCHES["dycore_fused"] += 1
    return f_new, stage
