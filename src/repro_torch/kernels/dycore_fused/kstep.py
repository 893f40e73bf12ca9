"""The CUDA k-step dycore kernel (`csrc/dycore_kstep.cu`) and its launcher.

Replaces the TPU kernel `fused_dycore_kstep_pallas`
(`repro.kernels.dycore_fused.fused`): k fused dycore steps of every field of
a field-stacked state in one launch, the state held in fp32 on chip between
the steps. The plain version beside it is `ref.fused_kstep_ref`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.core.spans import spanned
from repro_torch.kernels import _build
from repro_torch.kernels.dycore_fused.ref import DEFAULT_COEFF, DEFAULT_DT


@spanned("nero.kernel.dycore_kstep")
def fused_dycore_kstep_cuda(fs: torch.Tensor, w: torch.Tensor,
                            utens: torch.Tensor, utens_stage: torch.Tensor,
                            *, k_steps: int, coeff: float = DEFAULT_COEFF,
                            dt: float = DEFAULT_DT,
                            tile: Optional[tiling.CudaTile] = None):
    """`k_steps` dycore steps of field-stacked `fs`, `utens`, `utens_stage`
    `(..., nf, nz, ny, nx)`, doubly periodic in (y, x), in one launch; `w`
    is the pre-combined staggered velocity `wcon_i + wcon_{i+1}`, `(..., nz,
    ny, nx)`, shared by every field. All contiguous CUDA tensors of one
    dtype (float32 or bfloat16), 2 <= nz <= 64. Returns `(f_new, stage)`
    shaped like `fs`: the state after `k_steps` steps and the last step's
    stage. Nothing else is allocated: the round's working state stays on
    chip, apart from the few bytes a thread that ptxas spills to local
    memory (the build prints them)."""
    if fs.dim() < 4:
        raise ValueError(f"dycore k-step: fs must be (..., nf, nz, ny, nx), "
                         f"got {tuple(fs.shape)}")
    if not isinstance(k_steps, int) or k_steps < 1:
        raise ValueError(f"dycore k-step: k_steps={k_steps!r} must be a "
                         f"positive int")
    nf, nz, ny, nx = fs.shape[-4:]
    if nz < 2:
        raise ValueError(f"dycore k-step: nz={nz} must be >= 2 (staggered "
                         f"vertical sweep)")
    tiling.check_kstep_nz(nz)               # refuses nz > 64
    tile = tile or tiling.dycore_kstep_tile(ny, nx, k_steps, nz=nz)
    tw = tile.tx + 4 * k_steps
    if (tile.op != "dycore_kstep" or tile.threads != tile.rows * tw
            or tile.cluster * tile.rows < tile.ty + 4 * k_steps):
        raise ValueError(f"dycore k-step: tile {tile} was not planned for "
                         f"k_steps={k_steps} (tiling.dycore_kstep_tile)")
    if tiling.dycore_kstep_smem(nz, tile.rows, tw) > \
            tiling.SMEM_BYTES_PER_BLOCK:
        raise ValueError(f"dycore k-step: tile {tile} needs more than "
                         f"{tiling.SMEM_BYTES_PER_BLOCK} bytes of shared "
                         f"memory at nz={nz}")
    batch = math.prod(fs.shape[:-4])
    for name, t in (("fs", fs), ("utens", utens),
                    ("utens_stage", utens_stage)):
        _build.check_operand("dycore k-step", name, t, fs.shape, fs.dtype)
    _build.check_operand("dycore k-step", "w", w,
                         tuple(fs.shape[:-4]) + (nz, ny, nx), fs.dtype)
    f_new = torch.empty_like(fs)
    stage = torch.empty_like(fs)
    lib = _build.load()
    with torch.cuda.device(fs.device):
        err = lib.nero_dycore_kstep(
            fs.data_ptr(), w.data_ptr(), utens.data_ptr(),
            utens_stage.data_ptr(), f_new.data_ptr(), stage.data_ptr(),
            batch, nf, nz, ny, nx, dt, coeff, tile.ty, tile.tx, tile.rows,
            tile.cluster, k_steps, int(fs.dtype == torch.bfloat16),
            _build.stream_of(fs))
    _build.check(err, "dycore k-step")
    _build.LAUNCHES["dycore_kstep"] += 1
    return f_new, stage
