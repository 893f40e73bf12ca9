"""The hdiff step: periodic compound horizontal diffusion of every field."""

from __future__ import annotations

from bench.reference import stencils

# operations a field point a step: five Laplacians 25, four fluxes 4, the
# limiter 12, the output 5
FLOPS_PER_POINT = 46


def step_bytes(grid, members: int, n_fields: int, itemsize: int) -> int:
    nz, ny, nx = grid
    return 2 * n_fields * members * nz * ny * nx * itemsize


def step_flops(grid, members: int, n_fields: int) -> int:
    nz, ny, nx = grid
    return FLOPS_PER_POINT * members * n_fields * nz * ny * nx


def reference_step(state, coeff: float, dt: float):
    return dict(state, fields=stencils.hdiff_periodic(state["fields"], coeff))
