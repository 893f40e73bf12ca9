"""The CUDA vadvc kernel (`csrc/vadvc.cu`) and its launcher.

Replaces the TPU kernel `repro.kernels.vadvc.vadvc.vadvc_pallas`. The plain
version beside it is `ref.vadvc`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.core.spans import spanned
from repro_torch.kernels import _build


@spanned("nero.kernel.vadvc")
def vadvc_cuda(u_stage: torch.Tensor, wcon: torch.Tensor, u_pos: torch.Tensor,
               utens: torch.Tensor, utens_stage: torch.Tensor,
               tile: Optional[tiling.CudaTile] = None) -> torch.Tensor:
    """Thomas solve along z. Fields contiguous CUDA `(..., nz, ny, nx)`,
    float32 or bfloat16; `wcon` staggered `(..., nz, ny, nx + 1)` or
    periodic `(..., nz, ny, nx)` (column nx is column 0), its leading axes
    a prefix of the fields' (the fields of one ensemble member share their
    member's wcon). Returns the updated stage tendency. `u_pos` may be the
    same tensor as `u_stage`; the kernel then reads it once."""
    if u_stage.dim() < 3:
        raise ValueError(f"vadvc: fields must be (..., nz, ny, nx), got "
                         f"{tuple(u_stage.shape)}")
    nz, ny, nx = u_stage.shape[-3:]
    if nz < 2:
        raise ValueError(f"vadvc: nz={nz} must be >= 2 (staggered sweep)")
    lead, wlead = tuple(u_stage.shape[:-3]), tuple(wcon.shape[:-3])
    if lead[:len(wlead)] != wlead:
        raise ValueError(f"vadvc: wcon's leading axes {wlead} must be a "
                         f"prefix of the fields' {lead}")
    dt = u_stage.dtype
    for name, t in (("u_stage", u_stage), ("u_pos", u_pos), ("utens", utens),
                    ("utens_stage", utens_stage)):
        _build.check_operand("vadvc", name, t, u_stage.shape, dt)
    wcon_w = wcon.shape[-1] if wcon.dim() >= 3 else -1
    if wcon_w not in (nx, nx + 1):
        raise ValueError(f"vadvc: wcon rows are {wcon_w} wide; nx + 1 = "
                         f"{nx + 1} (staggered) or nx = {nx} (periodic)")
    _build.check_operand("vadvc", "wcon", wcon, wlead + (nz, ny, wcon_w), dt)
    batch = math.prod(lead)
    group = math.prod(lead[len(wlead):])
    isz = u_stage.element_size()
    tile = tile or tiling.vadvc_tile(ny, nx, nz, isz)
    if tiling.vadvc_smem(nz, tile.tx, isz) > tiling.SMEM_BYTES_PER_BLOCK:
        raise ValueError(f"vadvc: {tile.tx} columns of {nz} levels need "
                         f"{tiling.vadvc_smem(nz, tile.tx, isz)} bytes of "
                         f"shared memory; at most "
                         f"{tiling.SMEM_BYTES_PER_BLOCK}")
    out = torch.empty_like(u_stage)
    lib = _build.load()
    with torch.cuda.device(u_stage.device):
        err = lib.nero_vadvc(u_stage.data_ptr(), wcon.data_ptr(),
                             u_pos.data_ptr(), utens.data_ptr(),
                             utens_stage.data_ptr(), out.data_ptr(), batch,
                             group, nz, ny, nx, wcon_w, tile.tx,
                             int(dt == torch.bfloat16),
                             _build.stream_of(u_stage))
    _build.check(err, "vadvc")
    _build.LAUNCHES["vadvc"] += 1
    return out
