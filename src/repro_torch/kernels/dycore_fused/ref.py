"""Unfused oracle for the compound dycore field step, in plain PyTorch.

A port of `repro.kernels.dycore_fused.ref`: vertical advection (Thomas
solve) -> point-wise explicit update -> periodic compound horizontal
diffusion, each stage materialised, on a doubly periodic `(..., nz, ny, nx)`
domain with any leading batch axes. It is the plain version the fused CUDA
kernel (`fused.py`) is held against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.hdiff import ref as hdiff_ref
from repro_torch.kernels.vadvc import ref as vadvc_ref

DEFAULT_COEFF = hdiff_ref.DEFAULT_COEFF
DEFAULT_DT = 0.1
HALO = 2   # hdiff halo depth; the fused kernel's in-kernel y/x halo


def pad_periodic(f: torch.Tensor, halo: int = HALO) -> torch.Tensor:
    """Wrap-pad the two horizontal axes (..., ny, nx) by `halo`."""
    f = torch.cat([f[..., -halo:, :], f, f[..., :halo, :]], dim=-2)
    return torch.cat([f[..., :, -halo:], f, f[..., :, :halo]], dim=-1)


def fused_step_ref(f: torch.Tensor, wcon: torch.Tensor, utens: torch.Tensor,
                   utens_stage: torch.Tensor, coeff: float = DEFAULT_COEFF,
                   dt: float = DEFAULT_DT):
    """One dycore field step, unfused. All inputs `(..., nz, ny, nx)`;
    `wcon` is the unstaggered field (its x-staggered neighbour is the
    periodic next column). Returns `(f_new, stage)` shaped/typed like `f`.
    """
    # 1) tridiagonal vertical solve (u_pos == u_stage == f in the dycore).
    wcon_s = torch.cat([wcon, wcon[..., :1]], dim=-1)
    stage = vadvc_ref.vadvc(f, wcon_s, f, utens, utens_stage)
    return _update_and_diffuse(f, stage, coeff, dt), stage


def fused_step_ref_summed(f: torch.Tensor, w: torch.Tensor,
                          utens: torch.Tensor, utens_stage: torch.Tensor,
                          coeff: float = DEFAULT_COEFF,
                          dt: float = DEFAULT_DT):
    """`fused_step_ref` from the staggered sum `w = wcon_i + wcon_{i+1}`
    (periodic next column) that the fused kernel takes. In float32 it equals
    `fused_step_ref(f, wcon, ...)` with `w = ops.staggered_w(wcon)`."""
    stage = vadvc_ref.vadvc_summed(f, w, f, utens, utens_stage)
    return _update_and_diffuse(f, stage, coeff, dt), stage


def fused_kstep_ref(fs: torch.Tensor, w: torch.Tensor, utens: torch.Tensor,
                    utens_stage: torch.Tensor, k: int,
                    coeff: float = DEFAULT_COEFF, dt: float = DEFAULT_DT):
    """k fused steps, the plain version of the k-step kernel: k iterations
    of `fused_step_ref_summed` in float32 from the storage-dtype inputs,
    the field and the stage carried from step to step, rounded once to the
    storage dtype at the end (the TPU kernel keeps its state in fp32
    between steps). `w` is the staggered sum, broadcastable against `fs`.
    Returns `(f_new, stage)` after `k` steps, the stage the last step's."""
    f, stage = fs.float(), utens_stage.float()
    w, utens = w.float(), utens.float()
    for _ in range(k):
        f, stage = fused_step_ref_summed(f, w, utens, stage, coeff=coeff,
                                         dt=dt)
    return f.to(fs.dtype), stage.to(fs.dtype)


def _update_and_diffuse(f, stage, coeff, dt):
    ny, nx = f.shape[-2:]
    # 2) point-wise explicit update.
    f2 = f + dt * stage
    # 3) periodic compound horizontal diffusion (pad -> interior -> crop).
    out = hdiff_ref.hdiff(pad_periodic(f2, HALO), coeff=coeff)
    return out[..., HALO:HALO + ny, HALO:HALO + nx]


# Leading batch axes need no special handling in PyTorch.
fused_step_ref_batched = fused_step_ref


def limiter_fragile_mask(f2: torch.Tensor, noise: float = 1e-5
                         ) -> torch.Tensor:
    """Points whose COSMO flux-limiter branch decision sits within fp32
    noise of flipping (see the JAX package's docstring): outside this mask
    two evaluation orders of the same scheme must agree to 1e-5; inside it
    a limiter branch may flip. `f2` is the point-wise-updated field the
    hdiff stage consumes, `(..., ny, nx)`, periodic in (y, x)."""
    fragile = None
    for flux, is_fragile in _limiter_fluxes(f2, noise):
        fragile = is_fragile if fragile is None else fragile | is_fragile
    return fragile


def limiter_flip_bound(f2: torch.Tensor, coeff: float = DEFAULT_COEFF,
                       noise: float = 1e-5) -> torch.Tensor:
    """Per point, the most the compound hdiff output can move when its
    fragile limiter branches (`limiter_fragile_mask`) flip: a flip keeps or
    drops one flux term, so `coeff` times the sum of `|flux|` over the
    point's fragile fluxes; 0 where none is fragile."""
    bound = torch.zeros(f2.shape, dtype=torch.float32, device=f2.device)
    for flux, is_fragile in _limiter_fluxes(f2, noise):
        bound += torch.where(is_fragile, flux.abs(), 0.0)
    return coeff * bound


def _limiter_fluxes(f2, noise):
    """The four limited fluxes of each point of `f2` (flx, flx_m, fly,
    fly_m) in float32, each with whether its branch is within noise of
    flipping."""
    a = f2.float()

    def sh(v, dj, di):   # value at (j+dj, i+di), periodic
        return torch.roll(v, shifts=(-dj, -di), dims=(-2, -1))

    lap = (sh(a, 0, -1) + sh(a, 0, 1) + sh(a, -1, 0) + sh(a, 1, 0)) - 4.0 * a
    pairs = [
        (sh(lap, 0, 1) - lap, sh(a, 0, 1) - a),      # flx
        (lap - sh(lap, 0, -1), a - sh(a, 0, -1)),    # flx_m
        (sh(lap, 1, 0) - lap, sh(a, 1, 0) - a),      # fly
        (lap - sh(lap, -1, 0), a - sh(a, -1, 0)),    # fly_m
    ]
    for flux, df in pairs:
        tol = noise * (flux.abs() + df.abs()) + 1e-12
        yield flux, (flux * df).abs() <= tol
