"""Plain PyTorch COSMO vertical advection (Thomas tridiagonal solver).

A port of `repro.kernels.vadvc.ref.vadvc`, in the same fp32 operation
order: build the tridiagonal system, forward elimination, back
substitution, and the tendency `DTR_STAGE·(x - u_pos)`. Layout
`(..., nz, ny, nx)` with z at axis -3 and any leading batch axes; `wcon`
is staggered in x, `(..., nz, ny, nx + 1)`, or periodic, `(..., nz, ny,
nx)`, where column nx is column 0.

Beside it, as in the JAX package: `vadvc_np`, the float64 numpy oracle (a
Python loop over k, the clearest statement of the sweep), and
`tridiagonal_residual`, the property check that an output solves the
implicit system. Both take tensors or arrays, `(nz, ny, nx)` with a
staggered `(nz, ny, nx + 1)` wcon.
"""

from __future__ import annotations

import numpy as np
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


def _f64(x) -> np.ndarray:
    """A tensor (any dtype or device) or array as a float64 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def vadvc_np(u_stage, wcon, u_pos, utens, utens_stage) -> np.ndarray:
    """The float64 numpy oracle: fields (nz, ny, nx), wcon (nz, ny,
    nx + 1). Returns the updated utens_stage."""
    u_stage, wcon, u_pos, utens, utens_stage_in = (
        _f64(x) for x in (u_stage, wcon, u_pos, utens, utens_stage))
    nz, ny, nx = u_stage.shape

    ccol = np.empty_like(u_stage)
    dcol = np.empty_like(u_stage)
    wl = wcon[:, :, :nx]       # wcon(i)
    wr = wcon[:, :, 1:nx + 1]  # wcon(i+1)

    # forward sweep, k = 0 (no sub-diagonal; gcv from level k+1)
    gcv = 0.25 * (wr[1] + wl[1])
    cs = gcv * BET_M
    ccol[0] = gcv * BET_P
    bcol = DTR_STAGE - ccol[0]
    correction = -cs * (u_stage[1] - u_stage[0])
    dcol[0] = (DTR_STAGE * u_pos[0] + utens[0] + utens_stage_in[0]
               + correction)
    divided = 1.0 / bcol
    ccol[0] *= divided
    dcol[0] *= divided

    for k in range(1, nz - 1):             # 0 < k < nz - 1
        gav = -0.25 * (wr[k] + wl[k])
        gcv = 0.25 * (wr[k + 1] + wl[k + 1])
        as_ = gav * BET_M
        cs = gcv * BET_M
        acol = gav * BET_P
        ccol[k] = gcv * BET_P
        bcol = DTR_STAGE - acol - ccol[k]
        correction = (-as_ * (u_stage[k - 1] - u_stage[k])
                      - cs * (u_stage[k + 1] - u_stage[k]))
        dcol[k] = (DTR_STAGE * u_pos[k] + utens[k] + utens_stage_in[k]
                   + correction)
        divided = 1.0 / (bcol - ccol[k - 1] * acol)
        ccol[k] *= divided
        dcol[k] = (dcol[k] - dcol[k - 1] * acol) * divided

    k = nz - 1                             # no super-diagonal
    gav = -0.25 * (wr[k] + wl[k])
    as_ = gav * BET_M
    acol = gav * BET_P
    bcol = DTR_STAGE - acol
    correction = -as_ * (u_stage[k - 1] - u_stage[k])
    dcol[k] = (DTR_STAGE * u_pos[k] + utens[k] + utens_stage_in[k]
               + correction)
    divided = 1.0 / (bcol - ccol[k - 1] * acol)
    dcol[k] = (dcol[k] - dcol[k - 1] * acol) * divided

    out = np.empty_like(u_stage)           # backward sweep
    datac = dcol[nz - 1]
    out[nz - 1] = DTR_STAGE * (datac - u_pos[nz - 1])
    for k in range(nz - 2, -1, -1):
        datac = dcol[k] - ccol[k] * datac
        out[k] = DTR_STAGE * (datac - u_pos[k])
    return out


def _system_np(u_stage, wcon, u_pos, utens, utens_stage):
    """`_system` in float64 numpy from a staggered wcon (nz, ny, nx + 1)."""
    nx = u_stage.shape[-1]
    w = wcon[:, :, :nx] + wcon[:, :, 1:nx + 1]
    gav = -0.25 * w                                     # level k
    gcv = 0.25 * np.concatenate([w[1:], np.zeros_like(w[-1:])], axis=0)
    a = gav * BET_P
    a[0] = 0.0
    c = gcv * BET_P                                     # c[-1] == 0 already
    b = DTR_STAGE - a - c
    du = np.diff(u_stage, axis=0)                       # u[k+1]-u[k]
    d = DTR_STAGE * u_pos + utens + utens_stage
    d[1:] += (gav[1:] * BET_M) * du                     # -as*(u[k-1]-u[k])
    d[:-1] += -(gcv[:-1] * BET_M) * du                  # -cs*(u[k+1]-u[k])
    return a, b, c, d


def tridiagonal_residual(u_stage, wcon, u_pos, utens, utens_stage,
                         out) -> float:
    """max |A x - d| in float64, x reconstructed from `out`: the output
    solves the implicit system, whichever implementation made it."""
    u_stage, wcon, u_pos, utens, utens_stage, out = (
        _f64(v) for v in (u_stage, wcon, u_pos, utens, utens_stage, out))
    a, b, c, d = _system_np(u_stage, wcon, u_pos, utens, utens_stage)
    x = out / DTR_STAGE + u_pos
    ax = b * x
    ax[1:] += a[1:] * x[:-1]
    ax[:-1] += c[:-1] * x[1:]
    return float(np.max(np.abs(ax - d)))
