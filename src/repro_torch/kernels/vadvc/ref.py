"""Plain PyTorch COSMO vertical advection (Thomas tridiagonal solver).

A port of `repro.kernels.vadvc.ref.vadvc`, in the same fp32 operation
order: build the tridiagonal system, forward elimination, back
substitution, and the tendency `DTR_STAGE·(x - u_pos)`. Layout
`(..., nz, ny, nx)` with z at axis -3 and any leading batch axes; `wcon`
is staggered in x, `(..., nz, ny, nx + 1)`, or periodic, `(..., nz, ny,
nx)`, where column nx is column 0.
"""

from __future__ import annotations

import torch

DTR_STAGE = 3.0 / 20.0
BETA_V = 0.0
BET_M = 0.5 * (1.0 - BETA_V)
BET_P = 0.5 * (1.0 + BETA_V)


def _system(u_stage, w, u_pos, utens, utens_stage):
    """Tridiagonal system (a, b, c, d) along axis -3 from the staggered sum
    `w = wcon_i + wcon_{i+1}`. Row k:
    a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k], with a[0] = c[-1] = 0."""
    gav = -0.25 * w                                        # level k
    gcv = 0.25 * torch.cat([w[..., 1:, :, :],
                            torch.zeros_like(w[..., -1:, :, :])], dim=-3)
    a = gav * BET_P
    a[..., 0, :, :] = 0.0
    c = gcv * BET_P                                        # c[-1] == 0
    b = DTR_STAGE - a - c

    du = torch.diff(u_stage, dim=-3)                       # u[k+1]-u[k]
    d = DTR_STAGE * u_pos + utens + utens_stage
    d[..., 1:, :, :] += (gav[..., 1:, :, :] * BET_M) * du
    d[..., :-1, :, :] += -(gcv[..., :-1, :, :] * BET_M) * du
    return a, b, c, d


def vadvc(u_stage: torch.Tensor, wcon: torch.Tensor, u_pos: torch.Tensor,
          utens: torch.Tensor, utens_stage: torch.Tensor) -> torch.Tensor:
    """The updated stage tendency, shaped and typed like `u_stage`. Each
    staggered column is widened to float32 before the sum, as in the TPU
    kernel; a periodic wcon's right column at i = nx - 1 is its column 0."""
    nx = u_stage.shape[-1]
    wcon = wcon.float()
    if wcon.shape[-1] == nx:
        right = torch.roll(wcon, -1, dims=-1)
    elif wcon.shape[-1] == nx + 1:
        right = wcon[..., 1:nx + 1]
    else:
        raise ValueError(f"vadvc: wcon rows are {wcon.shape[-1]} wide; "
                         f"nx + 1 = {nx + 1} (staggered) or nx = {nx} "
                         f"(periodic)")
    return vadvc_summed(u_stage, wcon[..., :nx] + right, u_pos, utens,
                        utens_stage)


def vadvc_summed(u_stage: torch.Tensor, w: torch.Tensor, u_pos: torch.Tensor,
                 utens: torch.Tensor, utens_stage: torch.Tensor
                 ) -> torch.Tensor:
    """`vadvc` from the staggered sum `w = wcon_i + wcon_{i+1}`, `(..., nz,
    ny, nx)`, as the fused kernel takes it (summed in the storage dtype)."""
    in_dtype = u_stage.dtype
    a, b, c, d = _system(*(x.float() for x in (u_stage, w, u_pos, utens,
                                                utens_stage)))
    nz = u_stage.shape[-3]
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
    return (DTR_STAGE * (x - u_pos.float())).to(in_dtype)
