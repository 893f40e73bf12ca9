"""The vadvc step: every field's stage tendency from the implicit solve."""

from __future__ import annotations

from bench.reference import stencils

# operations a field point a step: the staggered sum 1, the tridiagonal
# system 16, the Thomas sweep 9, the tendency 2
FLOPS_PER_POINT = 28


def step_bytes(grid, members: int, n_fields: int, itemsize: int) -> int:
    nz, ny, nx = grid
    arrays = 3 * n_fields + 1 + n_fields
    return arrays * members * nz * ny * nx * itemsize


def step_flops(grid, members: int, n_fields: int) -> int:
    nz, ny, nx = grid
    return FLOPS_PER_POINT * members * n_fields * nz * ny * nx


def reference_step(state, coeff: float, dt: float):
    return dict(state, stage_tens=stencils.vadvc_step(
        state["fields"], state["wcon"], state["tens"], state["stage_tens"]))
