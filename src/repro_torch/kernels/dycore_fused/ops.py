"""Public entry points of the fused dycore step: the device decides.

* `fused_step_whole_state` — every field of a field-stacked state in ONE
  kernel launch, the shared staggered velocity read once per tile. The
  default (`variant="whole_state"`) hot path of compiled dycore plans.
* `fused_step` — one field per launch (`variant="per_field"`), the same
  kernel at nf = 1.
* `fused_step_kstep` — k steps of every field in ONE launch, the state
  held in fp32 between the steps (`variant="kstep"`).

A CPU tensor takes the plain unfused composition (`ref.fused_step_ref`,
`ref.fused_kstep_ref`); a CUDA tensor launches the kernel
(`fused.fused_dycore_cuda`, `kstep.fused_dycore_kstep_cuda`) or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tiling
from repro_torch.kernels.dycore_fused import ref as _ref
from repro_torch.kernels.dycore_fused.fused import fused_dycore_cuda
from repro_torch.kernels.dycore_fused.kstep import fused_dycore_kstep_cuda

DEFAULT_COEFF = _ref.DEFAULT_COEFF
DEFAULT_DT = _ref.DEFAULT_DT


def staggered_w(wcon: torch.Tensor) -> torch.Tensor:
    """`wcon_i + wcon_{i+1}` (periodic next column), summed in the storage
    dtype as the JAX package's `ops.py` does before its launch."""
    return wcon + torch.roll(wcon, -1, dims=-1)


def fused_step_whole_state(fs: torch.Tensor, wcon: torch.Tensor,
                           utens: torch.Tensor, utens_stage: torch.Tensor,
                           coeff: float = DEFAULT_COEFF,
                           dt: float = DEFAULT_DT,
                           tile: Optional[tiling.CudaTile] = None):
    """Whole-state fused step: `fs`, `utens`, `utens_stage` are
    field-stacked `(..., nf, nz, ny, nx)`; `wcon` is the shared unstaggered
    velocity `(..., nz, ny, nx)`. Returns `(f_new, stage)` shaped like
    `fs`."""
    if fs.device.type == "cpu":
        wb = wcon.unsqueeze(-4).expand(fs.shape)
        return _ref.fused_step_ref(fs, wb, utens, utens_stage, coeff=coeff,
                                   dt=dt)
    return fused_dycore_cuda(fs, staggered_w(wcon), utens, utens_stage,
                             coeff=coeff, dt=dt, tile=tile)


def fused_step(f: torch.Tensor, wcon: torch.Tensor, utens: torch.Tensor,
               utens_stage: torch.Tensor, coeff: float = DEFAULT_COEFF,
               dt: float = DEFAULT_DT,
               tile: Optional[tiling.CudaTile] = None):
    """One field, `(..., nz, ny, nx)`, every input alike. Returns
    `(f_new, stage)`."""
    if f.device.type == "cpu":
        return _ref.fused_step_ref(f, wcon, utens, utens_stage, coeff=coeff,
                                   dt=dt)
    one = lambda a: a.unsqueeze(-4)          # nf = 1
    f_new, stage = fused_dycore_cuda(one(f), staggered_w(wcon), one(utens),
                                     one(utens_stage), coeff=coeff, dt=dt,
                                     tile=tile)
    return f_new.squeeze(-4), stage.squeeze(-4)


def fused_step_kstep(fs: torch.Tensor, wcon: torch.Tensor,
                     utens: torch.Tensor, utens_stage: torch.Tensor,
                     k_steps: int = 2, coeff: float = DEFAULT_COEFF,
                     dt: float = DEFAULT_DT,
                     tile: Optional[tiling.CudaTile] = None):
    """`k_steps` whole-state steps in one launch; shapes as
    `fused_step_whole_state`. `w` is summed in the storage dtype, as the
    JAX package sums it, on either device. Returns `(f_new, stage)` after
    `k_steps` steps."""
    w = staggered_w(wcon)
    if fs.device.type == "cpu":
        return _ref.fused_kstep_ref(fs, w.unsqueeze(-4), utens, utens_stage,
                                    k_steps, coeff=coeff, dt=dt)
    return fused_dycore_kstep_cuda(fs, w, utens, utens_stage,
                                   k_steps=k_steps, coeff=coeff, dt=dt,
                                   tile=tile)
