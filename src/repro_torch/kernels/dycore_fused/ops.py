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

`plan_tile`, `plan_tile_whole_state`, `plan_tile_kstep` and `resolve_tile`
are the JAX package's window planners: the analytic model's y-extent of a
(nz, ty, nx) window over the variant's tile space, tuned under
`hwspec.default_spec()` and snapped as the JAX package snaps it. The
window is what `ExecutionPlan.report()["model"]` estimates. It does not
choose the kernel's tile: a launch takes `tiling.dycore_tile` /
`tiling.dycore_kstep_tile` (or the tile `compile(tune="measure")` timed
fastest on the device), since the model ranks windows differently from
the card. Where no window of the space fits the spec's near memory (the
z-by-x slabs never fit the H100's 227 KB), the window takes the kernel's
default rows; and a k-step window that outgrows it is not refused, since
the CUDA kernel's own tile decides which k runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import autotune, tiling
from repro_torch.core.spans import copied, spanned
from repro_torch.kernels.dycore_fused import ref as _ref
from repro_torch.kernels.dycore_fused.fused import fused_dycore_cuda
from repro_torch.kernels.dycore_fused.kstep import fused_dycore_kstep_cuda

DEFAULT_COEFF = _ref.DEFAULT_COEFF
DEFAULT_DT = _ref.DEFAULT_DT


def snap_ty(ty: int, ny: int) -> int:
    """Largest legal y-window <= `ty`: a divisor of ny, >= 2 (a single
    whole-y window when ny has no divisor in [2, ty])."""
    return tiling.snap_to_divisor(ty, ny, lo=2)


def plan_tile(grid_shape, dtype) -> int:
    """The model's y-window over the per-field space."""
    nz, ny, nx = grid_shape
    window = autotune.tuned_window(tiling.DYCORE_FUSED, grid_shape, dtype,
                                   (nz, tiling.dycore_default(1)[0], nx))
    return snap_ty(window[1], ny)


def plan_tile_whole_state(grid_shape, dtype, n_fields: int) -> int:
    """The model's y-window over the whole-state space of `n_fields`
    fields (w amortized in bytes but resident in near memory beside the
    field windows, so the legal set shifts with the field count)."""
    nz, ny, nx = grid_shape
    window = autotune.tuned_window(
        tiling.dycore_whole_state_spec(n_fields), grid_shape, dtype,
        (nz, tiling.dycore_default(n_fields)[0], nx))
    return snap_ty(window[1], ny)


def plan_tile_kstep(grid_shape, dtype, n_fields: int, k_steps: int,
                    hier=None) -> int:
    """The model's y-window over the k-step space (a three-window working
    slab), snapped to a divisor of ny that holds the k-step validity front
    (`tiling.snap_ty_kstep`, which refuses ny < 2k)."""
    nz, ny, nx = grid_shape
    window = autotune.tuned_window(
        tiling.dycore_kstep_spec(n_fields, k_steps), grid_shape, dtype,
        (nz, tiling.dycore_kstep_default(k_steps)[0], nx), hier=hier)
    return tiling.snap_ty_kstep(window[1], ny, k_steps)


def resolve_tile(variant: str, grid_shape, dtype, n_fields: int,
                 k_steps: int = 1, hier=None) -> Optional[int]:
    """The model's y-window of any variant; None for the unfused oracle,
    which has no kernel."""
    if variant == "unfused":
        return None
    if variant == "per_field":
        return plan_tile(grid_shape, dtype)
    if variant == "whole_state":
        return plan_tile_whole_state(grid_shape, dtype, n_fields)
    if variant == "kstep":
        return plan_tile_kstep(grid_shape, dtype, n_fields, k_steps,
                               hier=hier)
    raise ValueError(f"unknown dycore variant {variant!r}")


@spanned("nero.lower.staggered_w")
def staggered_w(wcon: torch.Tensor) -> torch.Tensor:
    """`wcon_i + wcon_{i+1}` (periodic next column), summed in the storage
    dtype as the JAX package's `ops.py` does before its launch; the roll
    and the sum are counted in `core/spans.py::LOWERING`."""
    return copied(wcon + copied(torch.roll(wcon, -1, dims=-1)))


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
    return fused_kstep_summed(fs, staggered_w(wcon), utens, utens_stage,
                              k_steps=k_steps, coeff=coeff, dt=dt, tile=tile)


def fused_step_summed(fs: torch.Tensor, w: torch.Tensor, utens: torch.Tensor,
                      utens_stage: torch.Tensor,
                      coeff: float = DEFAULT_COEFF, dt: float = DEFAULT_DT,
                      tile: Optional[tiling.CudaTile] = None):
    """`fused_step_whole_state` from the staggered sum `w`, `(..., nz, ny,
    nx)`, already built: a mesh round builds it on the padded slab from
    the neighbour's wcon column (`stencil_ops._dycore_shard_local`), where
    the periodic next column would be wrong at the slab's edge. The CPU
    takes `ref.fused_step_ref_summed`."""
    if fs.device.type == "cpu":
        return _ref.fused_step_ref_summed(fs, w.unsqueeze(-4), utens,
                                          utens_stage, coeff=coeff, dt=dt)
    return fused_dycore_cuda(fs, w, utens, utens_stage, coeff=coeff, dt=dt,
                             tile=tile)


def fused_kstep_summed(fs: torch.Tensor, w: torch.Tensor,
                       utens: torch.Tensor, utens_stage: torch.Tensor,
                       k_steps: int = 2, coeff: float = DEFAULT_COEFF,
                       dt: float = DEFAULT_DT,
                       tile: Optional[tiling.CudaTile] = None):
    """`fused_step_kstep` from the staggered sum `w` (see
    `fused_step_summed`)."""
    if fs.device.type == "cpu":
        return _ref.fused_kstep_ref(fs, w.unsqueeze(-4), utens, utens_stage,
                                    k_steps, coeff=coeff, dt=dt)
    return fused_dycore_kstep_cuda(fs, w, utens, utens_stage,
                                   k_steps=k_steps, coeff=coeff, dt=dt,
                                   tile=tile)
