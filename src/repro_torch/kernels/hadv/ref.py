"""Plain PyTorch first-order upwind horizontal advection.

A port of `repro.kernels.hadv.ref.hadv_upwind`, in the same fp32 operation
order:

    f' = f - cfl * ((f - f[y-1]) + (f - f[x-1]))

Layout `(..., ny, nx)`, every leading axis a batch of independent planes.
The stencil reaches backward only (unit positive wind), so its halo is one
point on the low side of each horizontal axis; row 0 and column 0 pass
through unchanged. `hadv_periodic` is the same step on a doubly periodic
plane: row -1 is row ny - 1, column -1 is column nx - 1, every point moves.
"""

from __future__ import annotations

import torch

DEFAULT_CFL = 0.1   # dt * u / dx for the unit-velocity donor cell


def hadv_upwind(src: torch.Tensor, cfl: float = DEFAULT_CFL) -> torch.Tensor:
    """Upwind advection step of `src` (..., ny, nx), ny, nx >= 2. Computes in
    fp32 (bf16 is rounded once); returns `src`'s shape and dtype."""
    f = src.float() if src.dtype == torch.bfloat16 else src
    c = f[..., 1:, 1:]
    ym = f[..., :-1, 1:]
    xm = f[..., 1:, :-1]
    out = f.clone()
    out[..., 1:, 1:] = c - cfl * ((c - ym) + (c - xm))
    return out.to(src.dtype)


def hadv_periodic(src: torch.Tensor, cfl: float = DEFAULT_CFL) -> torch.Tensor:
    """Upwind advection step of a doubly periodic `src` (..., ny, nx), in
    `hadv_upwind`'s fp32 operation order: the bits of padding the low sides
    by one wrapped row and column, `hadv_upwind`, and cropping the pad."""
    f = src.float() if src.dtype == torch.bfloat16 else src
    ym = torch.roll(f, 1, dims=-2)
    xm = torch.roll(f, 1, dims=-1)
    return (f - cfl * ((f - ym) + (f - xm))).to(src.dtype)
