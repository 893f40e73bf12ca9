"""The benchmark's input recipe: smooth-noise weather states from a seed.

A frozen copy of the program's smooth-noise recipe (a coarse normal grid,
upsampled trilinearly), so that a later change to the program cannot move
the inputs. A state is four field-stacked tensors: `fields`, `tens` and
`stage_tens` shaped `(E, nf, nz, ny, nx)`, and the shared vertical velocity
`wcon` shaped `(E, nz, ny, nx)`. Everything is drawn on the generator's
device in a few large calls.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

GROUPS = ("fields", "wcon", "tens", "stage_tens")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def smooth_noise(gen: torch.Generator, shape) -> torch.Tensor:
    """A band-limited float32 field of `shape` (..., nz, ny, nx)."""
    coarse = tuple(max(2, s // 8) for s in shape[-3:])
    x = torch.randn(tuple(shape[:-3]) + coarse, generator=gen,
                    device=gen.device, dtype=torch.float32)
    x = F.interpolate(x.reshape((-1, 1) + coarse), size=tuple(shape[-3:]),
                      mode="trilinear", align_corners=False)
    return x.reshape(shape)


def draw_state(gen: torch.Generator, grid, members: int, n_fields: int,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """One initial state: the fields, then their slow tendencies (scaled by
    0.01), then wcon (scaled by 0.15, so the implicit solve is well
    conditioned), drawn in that order; the stage tendencies start at 0."""
    shape = (members,) + tuple(grid)
    stacked = (members, n_fields) + tuple(grid)
    state = {"fields": torch.empty(stacked, dtype=dtype, device=gen.device),
             "tens": torch.empty(stacked, dtype=dtype, device=gen.device)}
    for i in range(n_fields):
        state["fields"][:, i] = smooth_noise(gen, shape)
    for i in range(n_fields):
        state["tens"][:, i] = 0.01 * smooth_noise(gen, shape)
    state["wcon"] = (0.15 * smooth_noise(gen, shape)).to(dtype)
    state["stage_tens"] = torch.zeros(stacked, dtype=dtype,
                                      device=gen.device)
    return state


def members_of(state: Dict[str, torch.Tensor], members) -> Dict[str, torch.Tensor]:
    """A copy of the given ensemble members of every group."""
    idx = torch.as_tensor(list(members), dtype=torch.long,
                          device=state["wcon"].device)
    return {g: state[g].index_select(0, idx) for g in GROUPS}


def state_bytes(grid, members: int, n_fields: int, dtype: torch.dtype) -> int:
    """Bytes of one state: three field-stacked groups and wcon."""
    nz, ny, nx = grid
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (3 * n_fields + 1) * members * nz * ny * nx * itemsize
