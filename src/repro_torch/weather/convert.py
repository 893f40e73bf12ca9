"""Carry a state across between the JAX package and the port, via numpy.

Field order and layout stay exactly the JAX package's. bfloat16 crosses as
a `uint16` view of its bits, because `torch.from_numpy` rejects numpy's
`bfloat16` (the ml_dtypes extension type).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.weather.fields import WeatherState, field_views


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """One array across; a bfloat16 array keeps its bits exactly."""
    a = np.array(a)          # a writable copy, C-contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor back; bfloat16 comes out as a `uint16` array of its bits
    (view it as `ml_dtypes.bfloat16` on the other side)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def state_from_numpy(fields: Dict[str, np.ndarray], wcon: np.ndarray,
                     tens: Dict[str, np.ndarray],
                     stage_tens: Dict[str, np.ndarray],
                     device="cuda") -> WeatherState:
    """The state of `([E,] nz, ny, nx)` arrays on `device`; each dict's
    fields become views of one field-stacked tensor, in the dict's order."""
    conv = lambda d: field_views(tensor_from_numpy(
        np.stack(list(d.values()), axis=-4), device), tuple(d))
    return WeatherState(fields=conv(fields),
                        wcon=tensor_from_numpy(wcon, device),
                        tens=conv(tens), stage_tens=conv(stage_tens))


def state_to_numpy(state: WeatherState) -> Tuple[Dict[str, np.ndarray],
                                                 np.ndarray,
                                                 Dict[str, np.ndarray],
                                                 Dict[str, np.ndarray]]:
    """`(fields, wcon, tens, stage_tens)` as numpy arrays, the inverse of
    `state_from_numpy`."""
    conv = lambda d: {k: tensor_to_numpy(v) for k, v in d.items()}
    return (conv(state.fields), tensor_to_numpy(state.wcon),
            conv(state.tens), conv(state.stage_tens))
