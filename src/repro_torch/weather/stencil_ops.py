"""The StencilOp registry: declared operators the planner compiles.

A port of `repro.weather.stencil_ops` for one device. Each operator is a
`StencilOpDef` declaring which state operands it streams, its per-operand
halo footprint (`OperandRide`), its stencil reach, flop count and execution
variants, and its lowerings: tile resolution and the single-device step.
`weather/program.py::compile` consumes only this declaration. Registered:

  "dycore"      — the fused compound step (vadvc + point-wise + hdiff);
  "hdiff"       — compound horizontal diffusion alone (fields only);
  "vadvc"       — vertical advection alone (updates the stage tendencies);
  "hadv_upwind" — first-order upwind advection (backward-only reach).

`dycore` and `hdiff` also run the k-step round (`variant="kstep"`): k
timesteps in ONE kernel launch. On one device the halo exchange of the JAX
package degenerates to periodic wrap-padding, which the lowerings here do
directly. Distributed rounds are later work (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import tiling
from repro_torch.core.hwspec import dtype_bytes
from repro_torch.kernels.dycore_fused import ops as fused_ops
from repro_torch.kernels.dycore_fused.ref import pad_periodic
from repro_torch.kernels.hadv import ops as hadv_ops
from repro_torch.kernels.hadv import ref as hadv_ref
from repro_torch.kernels.hdiff import ops as hdiff_ops
from repro_torch.kernels.hdiff import ref as hdiff_ref
from repro_torch.kernels.vadvc import ops as vadvc_ops
from repro_torch.kernels.vadvc import ref as vadvc_ref
from repro_torch.weather import dycore as _dycore
from repro_torch.weather.dycore import HALO
from repro_torch.weather.fields import WeatherState

VARIANTS = ("auto", "unfused", "per_field", "whole_state", "kstep")

# Useful flops per output point and step (the JAX package's tile specs).
DYCORE_FLOPS_PER_POINT = 61.0
HDIFF_FLOPS_PER_POINT = 21.0
VADVC_FLOPS_PER_POINT = 38.0
HADV_UPWIND_FLOPS_PER_POINT = 5.0


@dataclasses.dataclass(frozen=True)
class OperandRide:
    """One operand's declared halo footprint: per direction the per-side
    depth at steps-per-round k is `k * base + fixed`. `per_field` operands
    ride once per program field; others (wcon) once per state."""

    operand: str
    y: Tuple[int, int] = (0, 0)
    x: Tuple[int, int] = (0, 0)
    y_fixed: Tuple[int, int] = (0, 0)
    x_fixed: Tuple[int, int] = (0, 0)
    per_field: bool = False

    def depths(self, k: int):
        """Resolved ((y_lo, y_hi), (x_lo, x_hi)) at steps-per-round `k`."""
        return ((k * self.y[0] + self.y_fixed[0],
                 k * self.y[1] + self.y_fixed[1]),
                (k * self.x[0] + self.x_fixed[0],
                 k * self.x[1] + self.x_fixed[1]))

    def describe(self, k: int) -> Dict[str, Any]:
        dy, dx = self.depths(k)
        return {"operand": self.operand, "per_field": self.per_field,
                "depth_y": list(dy), "depth_x": list(dx)}


@dataclasses.dataclass(frozen=True)
class StencilOpDef:
    """A registered stencil operator: footprint declaration + lowerings.

    * `resolve_tile(variant, compute_grid, dtype, n_fields, ensemble, k)`
      -> `tiling.CudaTile`, or None for the unfused oracle variant;
    * `build_local_step(plan)` -> `state -> state`, the single-device round;
    * `pallas_calls(variant, n_fields, k)` -> kernel launches per round
      (the JAX package's key name, kept for schema parity).
    """

    name: str
    title: str
    reads: Tuple[str, ...]
    writes: Tuple[str, ...]
    halo: int                                # per-step stencil reach (y, x)
    flops_per_point: float                   # per field per step
    rides: Tuple[OperandRide, ...]
    variants: Tuple[str, ...]
    inkernel_kstep: bool = False             # k-step round is ONE launch
    pads_single_chip: bool = False           # single chip wrap-pads + crops
    packed_variants: Tuple[str, ...] = ()    # variants on the packed wire
    resolve_tile: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    build_local_step: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    pallas_calls: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)

    def resolved_rides(self, k: int):
        """((operand, (y_lo, y_hi), (x_lo, x_hi)), ...) at depth k."""
        return tuple((r.operand,) + r.depths(k) for r in self.rides)

    def describe(self, n_fields: int = 4, k: int = 1) -> Dict[str, Any]:
        """JSON footprint declaration (`plan.report()["footprint"]`)."""
        return {"op": self.name,
                "reads": list(self.reads),
                "writes": list(self.writes),
                "halo": self.halo,
                "flops_per_point": self.flops_per_point,
                "rides": [r.describe(k) for r in self.rides],
                "variants": list(self.variants),
                "inkernel_kstep": self.inkernel_kstep}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

STENCIL_OPS: Dict[str, StencilOpDef] = {}


def register_stencil_op(op: StencilOpDef) -> StencilOpDef:
    """Add (or replace) a stencil operator; returns it for chaining."""
    STENCIL_OPS[op.name] = op
    return op


def get_stencil_op(name: str) -> StencilOpDef:
    try:
        return STENCIL_OPS[name]
    except KeyError:
        raise KeyError(f"unknown stencil op {name!r}; registered: "
                       f"{sorted(STENCIL_OPS)}") from None


def registered_stencil_ops() -> Tuple[str, ...]:
    return tuple(sorted(STENCIL_OPS))


def _new_state(state: WeatherState, fields, stage_tens) -> WeatherState:
    return WeatherState(fields=fields, wcon=state.wcon, tens=state.tens,
                        stage_tens=stage_tens)


# ---------------------------------------------------------------------------
# "dycore" — the fused compound step
# ---------------------------------------------------------------------------


def _dycore_resolve_tile(variant, compute_grid, dtype, n_fields, ensemble,
                         k):
    if variant == "unfused":
        return None
    if variant == "kstep":
        return tiling.dycore_kstep_tile(compute_grid[1], compute_grid[2], k,
                                        nz=compute_grid[0])
    # per_field launches one field at a time: no fields to share w's
    # sweep coefficients, a cluster of one
    return tiling.dycore_tile(
        compute_grid[1], compute_grid[2], nz=compute_grid[0],
        nf=1 if variant == "per_field" else n_fields)


def _dycore_local_step(plan):
    """Single-device lowering at the plan's resolved tile."""
    prog = plan.program
    names, coeff, dt = prog.fields, prog.coeff, prog.dt
    variant, tile = plan.variant, plan.tile

    if variant == "unfused":
        def step(state: WeatherState) -> WeatherState:
            new_fields, new_stage = {}, {}
            for name in names:
                f = state.fields[name]
                stage = _dycore.vadvc_field(
                    u_stage=f, wcon=state.wcon, u_pos=f,
                    utens=state.tens[name],
                    utens_stage=state.stage_tens[name])
                new_fields[name] = _dycore.hdiff_periodic(f + dt * stage,
                                                          coeff)
                new_stage[name] = stage
            return _new_state(state, new_fields, new_stage)
        return step

    if variant == "per_field":
        def step(state: WeatherState) -> WeatherState:
            new_fields, new_stage = {}, {}
            for name in names:
                new_fields[name], new_stage[name] = fused_ops.fused_step(
                    state.fields[name].contiguous(), state.wcon.contiguous(),
                    state.tens[name].contiguous(),
                    state.stage_tens[name].contiguous(), coeff=coeff, dt=dt,
                    tile=tile)
            return _new_state(state, new_fields, new_stage)
        return step

    stack = lambda d: _dycore.stack_state(d, names)
    unstack = lambda a: _dycore.unstack_state(a, names)

    if variant == "whole_state":
        def step(state: WeatherState) -> WeatherState:
            f_new, stage = fused_ops.fused_step_whole_state(
                stack(state.fields), state.wcon.contiguous(),
                stack(state.tens), stack(state.stage_tens), coeff=coeff,
                dt=dt, tile=tile)
            return _new_state(state, unstack(f_new), unstack(stage))
        return step

    k = plan.k_steps

    def step(state: WeatherState) -> WeatherState:    # kstep: ONE launch
        f_new, stage = fused_ops.fused_step_kstep(
            stack(state.fields), state.wcon.contiguous(), stack(state.tens),
            stack(state.stage_tens), k_steps=k, coeff=coeff, dt=dt,
            tile=tile)
        return _new_state(state, unstack(f_new), unstack(stage))
    return step


register_stencil_op(StencilOpDef(
    name="dycore",
    title="fused compound dycore step (vadvc + point-wise + hdiff)",
    reads=("fields", "wcon", "tens", "stage_tens"),
    writes=("fields", "stage_tens"),
    halo=HALO,
    flops_per_point=DYCORE_FLOPS_PER_POINT,
    rides=(OperandRide("fields", y=(HALO, HALO), x=(HALO, HALO),
                       per_field=True),
           OperandRide("tens", y=(HALO, HALO), x=(HALO, HALO),
                       per_field=True),
           OperandRide("stage_tens", y=(HALO, HALO), x=(HALO, HALO),
                       per_field=True),
           OperandRide("wcon", y=(HALO, HALO), x=(HALO, HALO),
                       x_fixed=(0, 1))),
    variants=("unfused", "per_field", "whole_state", "kstep"),
    inkernel_kstep=True,
    pads_single_chip=False,
    packed_variants=("whole_state", "kstep"),
    resolve_tile=_dycore_resolve_tile,
    build_local_step=_dycore_local_step,
    pallas_calls=lambda variant, nf, k: {"unfused": 0, "per_field": nf,
                                         "whole_state": 1, "kstep": 1}[
                                             variant],
))


# ---------------------------------------------------------------------------
# "hdiff" — compound horizontal diffusion alone
# ---------------------------------------------------------------------------


def _hdiff_resolve_tile(variant, compute_grid, dtype, n_fields, ensemble,
                        k):
    if variant == "unfused":
        return None
    if variant == "kstep":
        return tiling.hdiff_kstep_tile(compute_grid[1], compute_grid[2], k)
    return tiling.hdiff_tile(compute_grid[1], compute_grid[2])


def _hdiff_local_step(plan):
    """Single-device hdiff round: wrap-pad by the round's reach, `k·2` (the
    JAX package's packed exchange on one shard), then the local compute —
    the oracle, one launch per field, one launch for the whole state (the
    fully z-parallel stencil folds (ensemble, field, z) into the kernel's
    plane axis), or ONE k-step launch for the whole round — and the interior
    crop. The k-step round is bit-equal to k whole-state rounds: each
    in-kernel step rounds through the storage dtype, and the crop keeps
    only points the k steps left exact."""
    prog = plan.program
    names, coeff, variant, tile = prog.fields, prog.coeff, plan.variant, \
        plan.tile
    k = plan.k_steps
    halo = k * HALO

    def step(state: WeatherState) -> WeatherState:
        fs = _dycore.stack_state(state.fields, names)   # (e, nf, nz, ly, lx)
        ly, lx = fs.shape[-2:]
        fs = pad_periodic(fs, halo)
        Y, X = fs.shape[-2:]
        if variant == "unfused":
            out = hdiff_ref.hdiff(fs.reshape(-1, Y, X), coeff=coeff)
        elif variant == "per_field":
            out = torch.stack(
                [hdiff_ops.hdiff(fs[:, i].reshape(-1, Y, X), coeff=coeff,
                                 tile=tile).reshape(fs[:, i].shape)
                 for i in range(len(names))], dim=1)
        elif variant == "whole_state":
            out = hdiff_ops.hdiff(fs.reshape(-1, Y, X), coeff=coeff,
                                  tile=tile)
        else:                                        # kstep: ONE launch
            out = hdiff_ops.hdiff_kstep(fs.reshape(-1, Y, X), coeff=coeff,
                                        k=k, tile=tile)
        out = out.reshape(fs.shape)[..., halo:halo + ly, halo:halo + lx]
        return _new_state(state, {n: out[:, i] for i, n in enumerate(names)},
                          dict(state.stage_tens))
    return step


register_stencil_op(StencilOpDef(
    name="hdiff",
    title="compound horizontal diffusion (laplace -> limited flux -> out)",
    reads=("fields",),
    writes=("fields",),
    halo=hdiff_ops.HALO,
    flops_per_point=HDIFF_FLOPS_PER_POINT,
    rides=(OperandRide("fields", y=(hdiff_ops.HALO, hdiff_ops.HALO),
                       x=(hdiff_ops.HALO, hdiff_ops.HALO), per_field=True),),
    variants=("unfused", "per_field", "whole_state", "kstep"),
    inkernel_kstep=True,
    pads_single_chip=True,
    packed_variants=("unfused", "per_field", "whole_state", "kstep"),
    resolve_tile=_hdiff_resolve_tile,
    build_local_step=_hdiff_local_step,
    pallas_calls=lambda variant, nf, k: {"unfused": 0, "per_field": nf,
                                         "whole_state": 1, "kstep": 1}[
                                             variant],
))


# ---------------------------------------------------------------------------
# "vadvc" — vertical advection alone
# ---------------------------------------------------------------------------


def _vadvc_resolve_tile(variant, compute_grid, dtype, n_fields, ensemble,
                        k):
    if variant == "unfused":
        return None
    nz, ny, nx = compute_grid
    return tiling.vadvc_tile(ny, nx, nz, dtype_bytes(dtype))


def _vadvc_local_step(plan):
    """Single-device vadvc round: the state's periodic wcon goes to the
    plain version or the kernel as it is (each wraps its right staggering
    column, the `(0, 1)` x-ride, itself); fields and tendencies need no
    halo. The kernel takes a member's wcon once for all the fields under
    it: per_field launches once per field over the ensemble, whole_state
    once over the field-stacked state."""
    prog = plan.program
    names, variant, tile = prog.fields, plan.variant, plan.tile

    def step(state: WeatherState) -> WeatherState:
        wcon = state.wcon
        if variant == "unfused":
            new_stage = {n: vadvc_ref.vadvc(state.fields[n], wcon,
                                            state.fields[n], state.tens[n],
                                            state.stage_tens[n])
                         for n in names}
        elif variant == "per_field":
            new_stage = {}
            for n in names:
                u = state.fields[n].contiguous()
                new_stage[n] = vadvc_ops.vadvc(
                    u, wcon, u, state.tens[n].contiguous(),
                    state.stage_tens[n].contiguous(), tile=tile)
        else:                                        # whole_state
            stack = lambda d: _dycore.stack_state(d, names)
            u = stack(state.fields)
            out = vadvc_ops.vadvc(u, wcon, u, stack(state.tens),
                                  stack(state.stage_tens), tile=tile)
            new_stage = _dycore.unstack_state(out, names)
        return _new_state(state, dict(state.fields), new_stage)
    return step


register_stencil_op(StencilOpDef(
    name="vadvc",
    title="vertical advection (implicit Thomas solve; updates stage_tens)",
    reads=("fields", "wcon", "tens", "stage_tens"),
    writes=("stage_tens",),
    halo=0,
    flops_per_point=VADVC_FLOPS_PER_POINT,
    rides=(OperandRide("wcon", x_fixed=(0, 1)),),
    variants=("unfused", "per_field", "whole_state"),
    inkernel_kstep=False,
    pads_single_chip=True,
    packed_variants=("unfused", "per_field", "whole_state"),
    resolve_tile=_vadvc_resolve_tile,
    build_local_step=_vadvc_local_step,
    pallas_calls=lambda variant, nf, k: {"unfused": 0, "per_field": nf,
                                         "whole_state": 1}[variant],
))


# ---------------------------------------------------------------------------
# "hadv_upwind" — first-order upwind horizontal advection (backward-only
# reach: the registry's asymmetric-ride op)
# ---------------------------------------------------------------------------


def _hadv_resolve_tile(variant, compute_grid, dtype, n_fields, ensemble, k):
    if variant == "unfused":
        return None
    # the kernel runs on the unpadded planes
    return tiling.hadv_tile(compute_grid[1] - 2 * hadv_ops.HALO,
                            compute_grid[2] - 2 * hadv_ops.HALO,
                            dtype_bytes(dtype))


def _hadv_local_step(plan):
    """Single-device hadv round: the periodic step on the field-stacked
    state, by the oracle or one launch for the whole state, whose output
    is a new contiguous field-stacked state (the next step stacks it
    without a copy). The wrap the JAX package gets from its packed exchange
    at the asymmetric `(1, 0)` depth is read inside the step: the result is
    that of wrap-padding the low sides by 1, the passthrough step and the
    interior crop. The compute grid the plan reports is padded
    symmetrically, as the JAX package reports it."""
    prog = plan.program
    names, cfl, variant, tile = prog.fields, prog.coeff, plan.variant, \
        plan.tile

    def step(state: WeatherState) -> WeatherState:
        fs = _dycore.stack_state(state.fields, names)   # (e, nf, nz, ly, lx)
        planes = fs.reshape((-1,) + fs.shape[-2:])
        if variant == "unfused":
            out = hadv_ref.hadv_periodic(planes, cfl=cfl)
        else:                                        # whole_state
            out = hadv_ops.hadv_upwind(planes, cfl=cfl, tile=tile,
                                       periodic=True)
        return _new_state(state, _dycore.unstack_state(out.reshape(fs.shape),
                                                       names),
                          dict(state.stage_tens))
    return step


register_stencil_op(StencilOpDef(
    name="hadv_upwind",
    title="upwind horizontal advection (donor cell, backward-only reach)",
    reads=("fields",),
    writes=("fields",),
    halo=hadv_ops.HALO,
    flops_per_point=HADV_UPWIND_FLOPS_PER_POINT,
    rides=(OperandRide("fields", y=(hadv_ops.HALO, 0),
                       x=(hadv_ops.HALO, 0), per_field=True),),
    variants=("unfused", "whole_state"),
    inkernel_kstep=False,
    pads_single_chip=True,
    packed_variants=("unfused", "whole_state"),
    resolve_tile=_hadv_resolve_tile,
    build_local_step=_hadv_local_step,
    pallas_calls=lambda variant, nf, k: {"unfused": 0,
                                         "whole_state": 1}[variant],
))
