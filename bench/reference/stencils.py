"""Plain PyTorch reference of the weather stencils the benchmark checks.

A frozen, self-contained statement of COSMO's compound horizontal diffusion
(hdiff, with the flux limiter), the vertical advection's implicit Thomas
solve (vadvc) and the dycore step that chains them (vadvc, the point-wise
explicit update, periodic hdiff) on a doubly periodic (y, x) domain. Every
operation runs in the dtype of its inputs; in float32 it follows the
operation order of the program's published plain versions.

Layouts: a field is `(..., nz, ny, nx)`; `wcon` is the unstaggered vertical
velocity, periodic in x (its column nx is column 0). Nothing here imports
the program under test.
"""

from __future__ import annotations

import torch

HALO = 2                       # hdiff's one-sided reach in y and x
DTR_STAGE = 3.0 / 20.0
BETA_V = 0.0
BET_M = 0.5 * (1.0 - BETA_V)
BET_P = 0.5 * (1.0 + BETA_V)


def pad_periodic(f: torch.Tensor, halo: int = HALO) -> torch.Tensor:
    """Wrap-pad the two horizontal axes by `halo`."""
    f = torch.cat([f[..., -halo:, :], f, f[..., :halo, :]], dim=-2)
    return torch.cat([f[..., :, -halo:], f, f[..., :, :halo]], dim=-1)


def _s(f: torch.Tensor, dj: int, di: int) -> torch.Tensor:
    """`f` shifted by (dj, di), cropped to the interior of a halo-2 plane."""
    ny, nx = f.shape[-2:]
    return f[..., 2 + dj: ny - 2 + dj, 2 + di: nx - 2 + di]


def _lap(f: torch.Tensor, dj: int, di: int) -> torch.Tensor:
    return ((_s(f, dj, di - 1) + _s(f, dj, di + 1)
             + _s(f, dj - 1, di) + _s(f, dj + 1, di))
            - 4.0 * _s(f, dj, di))


def hdiff_padded(f: torch.Tensor, coeff: float) -> torch.Tensor:
    """Compound diffusion of a halo-2 padded `(..., ny + 4, nx + 4)` plane
    stack; returns the `(..., ny, nx)` interior."""
    lap_c = _lap(f, 0, 0)
    flx = _lap(f, 0, 1) - lap_c
    flx_m = lap_c - _lap(f, 0, -1)
    fly = _lap(f, 1, 0) - lap_c
    fly_m = lap_c - _lap(f, -1, 0)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    # COSMO's flux limiter: a flux with flux * delta-f > 0 is zeroed
    flx = torch.where(flx * (_s(f, 0, 1) - _s(f, 0, 0)) > 0.0, zero, flx)
    flx_m = torch.where(flx_m * (_s(f, 0, 0) - _s(f, 0, -1)) > 0.0, zero,
                        flx_m)
    fly = torch.where(fly * (_s(f, 1, 0) - _s(f, 0, 0)) > 0.0, zero, fly)
    fly_m = torch.where(fly_m * (_s(f, 0, 0) - _s(f, -1, 0)) > 0.0, zero,
                        fly_m)
    return _s(f, 0, 0) - coeff * ((flx - flx_m) + (fly - fly_m))


def hdiff_periodic(f: torch.Tensor, coeff: float) -> torch.Tensor:
    """Periodic compound diffusion of `(..., nz, ny, nx)` fields."""
    return hdiff_padded(pad_periodic(f), coeff)


def vadvc(u: torch.Tensor, w: torch.Tensor, utens: torch.Tensor,
          utens_stage: torch.Tensor) -> torch.Tensor:
    """The updated stage tendency of the dycore's vadvc, where the stage and
    position fields are both `u`. `w` is the staggered sum
    `wcon_i + wcon_{i+1}`, broadcastable against `u`."""
    zero_level = torch.zeros_like(w[..., -1:, :, :])
    gav = -0.25 * w
    gcv = 0.25 * torch.cat([w[..., 1:, :, :], zero_level], dim=-3)
    a = gav * BET_P
    a[..., 0, :, :] = 0.0
    c = gcv * BET_P
    b = DTR_STAGE - a - c
    du = torch.diff(u, dim=-3)
    d = DTR_STAGE * u + utens + utens_stage
    d[..., 1:, :, :] += (gav[..., 1:, :, :] * BET_M) * du
    d[..., :-1, :, :] += -(gcv[..., :-1, :, :] * BET_M) * du
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    nz = u.shape[-3]
    cp = [c[..., 0, :, :] / b[..., 0, :, :]]
    dp = [d[..., 0, :, :] / b[..., 0, :, :]]
    for k in range(1, nz):                  # forward elimination
        a_k = a[..., k, :, :]
        denom = 1.0 / (b[..., k, :, :] - cp[-1] * a_k)
        cp.append(c[..., k, :, :] * denom)
        dp.append((d[..., k, :, :] - dp[-1] * a_k) * denom)
    x = [dp[-1]]
    for k in range(nz - 2, -1, -1):         # back substitution
        x.append(dp[k] - cp[k] * x[-1])
    x = torch.stack(x[::-1], dim=-3)
    return DTR_STAGE * (x - u)


def staggered(wcon: torch.Tensor) -> torch.Tensor:
    """`wcon_i + wcon_{i+1}`, the next column periodic."""
    return wcon + torch.roll(wcon, -1, dims=-1)


def vadvc_step(fields, wcon, tens, stage):
    """The stage tendency of every field of field-stacked `(E, nf, nz, ny,
    nx)` fields and tendencies under a shared `(E, nz, ny, nx)` wcon."""
    return vadvc(fields, staggered(wcon).unsqueeze(-4), tens, stage)


def dycore_step(fields, wcon, tens, stage, coeff: float, dt: float):
    """One dycore step (shapes as `vadvc_step`). Returns `(fields,
    stage)`."""
    new_stage = vadvc_step(fields, wcon, tens, stage)
    return hdiff_periodic(fields + dt * new_stage, coeff), new_stage
