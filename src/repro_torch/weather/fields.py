"""COSMO-like weather state: prognostic fields on a (nz, ny, nx) grid.

`WeatherState` is a dataclass of tensors, each shaped `(E, nz, ny, nx)` with
`E` the ensemble axis. Field order and layout are the JAX package's, so a
state converts across through `weather/convert.py` without reshaping.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PROGNOSTIC = ("u", "v", "t", "pp")   # wind u/v, temperature, pressure pert.

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_name(dtype) -> str:
    """Canonical string of a dtype given as a string, a numpy dtype or a
    torch dtype ("float32", "bfloat16", ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype
    return str(np.dtype(dtype))


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a state precision policy; float32 or bfloat16."""
    name = dtype_name(dtype)
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype {name!r}: the port stores state in "
                         f"{sorted(_TORCH_DTYPES)}") from None


@dataclasses.dataclass
class WeatherState:
    """Prognostic fields + vertical contravariant velocity `wcon` (its
    x-staggered neighbour is built on use by periodic wrap) + slow
    tendencies + the stage tendencies that vadvc updates."""

    fields: Dict[str, torch.Tensor]         # each (E, nz, ny, nx)
    wcon: torch.Tensor                      # (E, nz, ny, nx)
    tens: Dict[str, torch.Tensor]           # slow tendencies, like fields
    stage_tens: Dict[str, torch.Tensor]     # vadvc-updated tendencies

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return tuple(self.wcon.shape[-3:])

    @property
    def device(self) -> torch.device:
        return self.wcon.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wcon.dtype


def state_leaves(state: WeatherState) -> list:
    """The state's leaves in the JAX package's flatten order: the sorted
    fields, wcon, the sorted tens, the sorted stage_tens (each dict by the
    sorted field names)."""
    keys = sorted(state.fields)
    return ([state.fields[k] for k in keys] + [state.wcon]
            + [state.tens[k] for k in keys]
            + [state.stage_tens[k] for k in keys])


def field_views(stacked: torch.Tensor,
                names: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """Per-name views of a field-stacked `(..., nf, nz, ny, nx)` tensor: the
    layout every state constructor gives, so a whole-state kernel takes the
    stacked tensor without a copy (`weather/dycore.py::stack_state`)."""
    return dict(zip(names, stacked.unbind(-4)))


def zeros_state(grid_shape: Tuple[int, int, int], ensemble: int = 1,
                dtype=torch.float32, names: Tuple[str, ...] = PROGNOSTIC,
                device="cuda") -> WeatherState:
    """An all-zero state (zeros are a fixed point of the stencils)."""
    shape = (ensemble,) + tuple(grid_shape)
    dt = torch_dtype(dtype)
    z = lambda: field_views(torch.zeros((ensemble, len(names)) + shape[1:],
                                        dtype=dt, device=device), names)
    return WeatherState(fields=z(),
                        wcon=torch.zeros(shape, dtype=dt, device=device),
                        tens=z(), stage_tens=z())


def _smooth_noise(gen: torch.Generator, shape) -> torch.Tensor:
    """Band-limited random field: a coarse normal grid, upsampled
    trilinearly. Drawn in float32 on the generator's device."""
    coarse = tuple(max(2, s // 8) for s in shape[-3:])
    x = torch.randn(tuple(shape[:-3]) + coarse, generator=gen,
                    device=gen.device, dtype=torch.float32)
    x = F.interpolate(x.reshape((-1, 1) + coarse), size=tuple(shape[-3:]),
                      mode="trilinear", align_corners=False)
    return x.reshape(shape)


def initial_state(gen: torch.Generator, grid_shape: Tuple[int, int, int],
                  ensemble: int = 1, dtype=torch.float32,
                  device="cuda") -> WeatherState:
    """The JAX package's smooth-noise recipe, drawn from `gen`. The numbers
    differ from `jax.random`'s; parity tests hand states across instead
    (`weather/convert.py`)."""
    shape = (ensemble,) + tuple(grid_shape)
    dt = torch_dtype(dtype)
    put = lambda x: x.to(device=device, dtype=dt)
    stacked = lambda xs: field_views(put(torch.stack(xs, dim=1)), PROGNOSTIC)
    fields = stacked([_smooth_noise(gen, shape) for _ in PROGNOSTIC])
    tens = stacked([0.01 * _smooth_noise(gen, shape) for _ in PROGNOSTIC])
    stage = field_views(torch.zeros((ensemble, len(PROGNOSTIC)) + shape[1:],
                                    dtype=dt, device=device), PROGNOSTIC)
    # wcon scaled so the implicit solve is well conditioned
    # (physically |wcon·dt/dz| << 1).
    wcon = put(0.15 * _smooth_noise(gen, shape))
    return WeatherState(fields=fields, wcon=wcon, tens=tens, stage_tens=stage)
