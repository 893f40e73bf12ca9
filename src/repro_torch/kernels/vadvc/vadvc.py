"""The CUDA vadvc kernel (`csrc/vadvc.cu`) and its launcher.

Replaces the TPU kernel `repro.kernels.vadvc.vadvc.vadvc_pallas`. The plain
version beside it is `ref.vadvc`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.kernels import _build


def vadvc_cuda(u_stage: torch.Tensor, wcon: torch.Tensor, u_pos: torch.Tensor,
               utens: torch.Tensor, utens_stage: torch.Tensor,
               tile: Optional[tiling.CudaTile] = None) -> torch.Tensor:
    """Thomas solve along z. Fields contiguous CUDA `(..., nz, ny, nx)`,
    float32 or bfloat16; `wcon` staggered `(..., nz, ny, nx + 1)`, its
    leading axes a prefix of the fields' (the fields of one ensemble member
    share their member's wcon). Returns the updated stage tendency.
    `u_pos` may be the same tensor as `u_stage`."""
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
    _build.check_operand("vadvc", "wcon", wcon, wlead + (nz, ny, nx + 1), dt)
    batch = math.prod(lead)
    group = math.prod(lead[len(wlead):])
    tile = tile or tiling.vadvc_tile(ny, nx)
    out = torch.empty_like(u_stage)
    ccol = torch.empty(u_stage.shape, dtype=torch.float32,
                       device=u_stage.device)
    dcol = torch.empty_like(ccol)
    lib = _build.load()
    with torch.cuda.device(u_stage.device):
        err = lib.nero_vadvc(u_stage.data_ptr(), wcon.data_ptr(),
                             u_pos.data_ptr(), utens.data_ptr(),
                             utens_stage.data_ptr(), out.data_ptr(),
                             ccol.data_ptr(), dcol.data_ptr(), batch, group,
                             nz, ny, nx, tile.ty, tile.tx,
                             int(dt == torch.bfloat16),
                             _build.stream_of(u_stage))
    _build.check(err, "vadvc")
    _build.LAUNCHES["vadvc"] += 1
    return out
