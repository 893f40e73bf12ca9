"""COSMO-like dynamical core pieces in plain PyTorch.

One timestep applies the paper's three patterns: horizontal stencils
(hdiff), tridiagonal solves in the vertical (vadvc) and the point-wise
explicit update. The execution strategy is resolved by the plan API
(`weather/program.py`) over the op registry (`weather/stencil_ops.py`);
these periodic helpers and the state stack/unstack utilities are what the
unfused lowerings build on. The domain is doubly periodic in (y, x).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.hdiff import ref as hdiff_ref
from repro_torch.kernels.vadvc import ref as vadvc_ref
from repro_torch.weather.fields import PROGNOSTIC

HALO = 2   # hdiff needs 2; vadvc needs 1 (staggered wcon)


def hdiff_periodic(src: torch.Tensor, coeff: float) -> torch.Tensor:
    """Periodic compound horizontal diffusion of a (..., nz, ny, nx) field
    (`kernels/hdiff/ref.py::hdiff_periodic`)."""
    return hdiff_ref.hdiff_periodic(src, coeff=coeff)


def vadvc_field(u_stage, wcon, u_pos, utens, utens_stage):
    """vadvc over a (..., nz, ny, nx) field. `wcon` is (..., nz, ny, nx),
    periodic: its column nx is column 0."""
    return vadvc_ref.vadvc(u_stage, wcon, u_pos, utens, utens_stage)


def stack_state(d: dict, names=PROGNOSTIC) -> torch.Tensor:
    """Stack the per-field dict onto a new axis -4: (..., nf, nz, ny, nx),
    in the order `names` gives. When the fields already are the planes of
    one contiguous field-stacked tensor, in that order (as `unstack_state`
    and every state constructor leave them), that tensor comes back as a
    view and nothing is copied."""
    ts = [d[name] for name in names]
    stacked = _stacked_base(ts)
    return torch.stack(ts, dim=-4) if stacked is None else stacked


def unstack_state(a: torch.Tensor, names=PROGNOSTIC) -> dict:
    """Inverse of `stack_state` (views into `a`)."""
    return {name: a.select(-4, i) for i, name in enumerate(names)}


def _stacked_base(ts):
    """The contiguous `(..., len(ts), nz, ny, nx)` tensor whose planes on
    axis -4 are exactly `ts`, or None."""
    t0 = ts[0]
    if t0.dim() < 3 or any(t.shape != t0.shape or t.dtype != t0.dtype
                           or t.device != t0.device for t in ts):
        return None
    shape = t0.shape[:-3] + (len(ts),) + t0.shape[-3:]
    strides, n = [], 1
    for s in reversed(shape):                   # contiguous strides
        strides.insert(0, n)
        n *= s
    if t0.untyped_storage().nbytes() < (t0.storage_offset() + n) * \
            t0.element_size():
        return None
    base = t0.as_strided(shape, strides, t0.storage_offset())
    for i, t in enumerate(ts):
        plane = base.select(-4, i)
        if (t.untyped_storage().data_ptr() != t0.untyped_storage().data_ptr()
                or t.storage_offset() != plane.storage_offset()
                or t.stride() != plane.stride()):
            return None
    return base
