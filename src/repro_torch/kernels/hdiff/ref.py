"""Plain PyTorch COSMO horizontal diffusion compound stencil.

A line-for-line port of `repro.kernels.hdiff.ref.hdiff`, in the same fp32
operation order: laplace -> flux -> COSMO flux limiter -> output
(`limit=False`, and `hdiff_simple`: the paper's Algorithm 1 without the
limiter, a plain version only; the CUDA kernel always limits). Layout
`(..., ny, nx)`, every leading axis a batch of independent planes; halo 2
in y and x; the 2-wide boundary ring passes through unchanged.
`hdiff_periodic` is the step on a doubly periodic plane: wrap-pad by 2,
`hdiff`, crop the pad.
"""

from __future__ import annotations

import torch

DEFAULT_COEFF = 0.025


def _s(f: torch.Tensor, dj: int, di: int) -> torch.Tensor:
    """View of `f` shifted by (dj, di), cropped to the interior (halo 2)."""
    ny, nx = f.shape[-2:]
    return f[..., 2 + dj: ny - 2 + dj, 2 + di: nx - 2 + di]


def _lap(f: torch.Tensor, dj: int, di: int) -> torch.Tensor:
    """5-point Laplacian (Σ neighbours - 4·centre) at offset (dj, di)."""
    return ((_s(f, dj, di - 1) + _s(f, dj, di + 1)
             + _s(f, dj - 1, di) + _s(f, dj + 1, di))
            - 4.0 * _s(f, dj, di))


def hdiff(src: torch.Tensor, coeff: float = DEFAULT_COEFF,
          limit: bool = True) -> torch.Tensor:
    """Compound horizontal diffusion of `src` (..., ny, nx), ny, nx >= 5,
    with the flux limiter unless `limit=False`. Computes in fp32; returns
    `src`'s shape and dtype."""
    f = src.float() if src.dtype == torch.bfloat16 else src

    lap_c = _lap(f, 0, 0)
    flx = _lap(f, 0, 1) - lap_c          # flux between (i) and (i+1)
    flx_m = lap_c - _lap(f, 0, -1)       # flux between (i-1) and (i)
    fly = _lap(f, 1, 0) - lap_c
    fly_m = lap_c - _lap(f, -1, 0)

    if limit:   # COSMO flux limiter: a flux with flux·Δf > 0 is zeroed.
        zero = torch.zeros((), dtype=f.dtype, device=f.device)
        flx = torch.where(flx * (_s(f, 0, 1) - _s(f, 0, 0)) > 0.0, zero, flx)
        flx_m = torch.where(flx_m * (_s(f, 0, 0) - _s(f, 0, -1)) > 0.0, zero,
                            flx_m)
        fly = torch.where(fly * (_s(f, 1, 0) - _s(f, 0, 0)) > 0.0, zero, fly)
        fly_m = torch.where(fly_m * (_s(f, 0, 0) - _s(f, -1, 0)) > 0.0, zero,
                            fly_m)

    interior = _s(f, 0, 0) - coeff * ((flx - flx_m) + (fly - fly_m))
    out = f.clone()
    out[..., 2:-2, 2:-2] = interior
    return out.to(src.dtype)


def hdiff_periodic(src: torch.Tensor,
                   coeff: float = DEFAULT_COEFF) -> torch.Tensor:
    """Compound horizontal diffusion of a doubly periodic `src` (..., ny,
    nx), ny, nx >= 2: `hdiff` of the plane wrap-padded by 2, cropped to a
    new contiguous tensor, so every point moves."""
    ny, nx = src.shape[-2:]
    f = torch.cat([src[..., -2:, :], src, src[..., :2, :]], dim=-2)
    f = torch.cat([f[..., :, -2:], f, f[..., :, :2]], dim=-1)
    return hdiff(f, coeff=coeff)[..., 2:2 + ny, 2:2 + nx].contiguous()


def hdiff_simple(src: torch.Tensor,
                 coeff: float = DEFAULT_COEFF) -> torch.Tensor:
    """The paper's Algorithm 1 without the flux limiter."""
    return hdiff(src, coeff=coeff, limit=False)


def hdiff_kstep(src: torch.Tensor, coeff: float = DEFAULT_COEFF,
                k: int = 1) -> torch.Tensor:
    """`k` steps of `hdiff`, each rounded through `src`'s dtype, as `k`
    separate launches round (the plain version of the k-step kernel)."""
    for _ in range(k):
        src = hdiff(src, coeff=coeff)
    return src
