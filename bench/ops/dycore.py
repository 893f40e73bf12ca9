"""The dycore step: vadvc, the point-wise update, periodic hdiff."""

from __future__ import annotations

from bench.reference import stencils

# operations a field point a step, counted from the reference: vadvc 28
# (see vadvc.py), the update 2, hdiff 46 (see hdiff.py)
FLOPS_PER_POINT = 76


def step_bytes(grid, members: int, n_fields: int, itemsize: int) -> int:
    nz, ny, nx = grid
    arrays = 3 * n_fields + 1 + 2 * n_fields
    return arrays * members * nz * ny * nx * itemsize


def step_flops(grid, members: int, n_fields: int) -> int:
    nz, ny, nx = grid
    return FLOPS_PER_POINT * members * n_fields * nz * ny * nx


def reference_step(state, coeff: float, dt: float):
    fields, stage = stencils.dycore_step(state["fields"], state["wcon"],
                                         state["tens"], state["stage_tens"],
                                         coeff, dt)
    return dict(state, fields=fields, stage_tens=stage)
