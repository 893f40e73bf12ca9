"""The StencilOp registry: declared operators the planner compiles.

A port of `repro.weather.stencil_ops`. Each operator is a `StencilOpDef`
declaring which state operands it streams, its per-operand halo footprint
(`OperandRide`), its stencil reach, flop count and execution variants, and
its lowerings: tile resolution, the single-device step, the shard-local
round of a mesh and, for a chainable op, its full-slab pipeline stage.
`weather/program.py::compile` consumes only this declaration. Registered:

  "dycore"       — the fused compound step (vadvc + point-wise + hdiff);
  "hdiff"        — compound horizontal diffusion alone (fields only);
  "vadvc"        — vertical advection alone (updates the stage tendencies);
  "vadvc_update" — vadvc and the point-wise update `f + dt * stage` (writes
                   fields and stage tendencies; no hdiff);
  "hadv_upwind"  — first-order upwind advection (backward-only reach);
  "asselin"      — the point-wise time filter from the stored tendencies
                   (no ride, no kernel);
  "pipeline(...)" — each chain of the ops above that a
                   `weather/pipeline.py::PipelineProgram` builds registers
                   itself under its signature.

Every op but `dycore` is `chainable`: a pipeline chain runs its solo step
as one of its stages.

`dycore` and `hdiff` also run the k-step round (`variant="kstep"`): k
timesteps in ONE kernel launch. On one device the halo exchange of the JAX
package degenerates to periodic wrap-padding, which the single-device
lowerings do directly, or which the one-step hdiff and hadv rounds read
inside the launch (the kernels' periodic modes). On a mesh
(`build_shard_local`) every op runs the
JAX package's shard-local round over all shards at once: the exchange of
its declared rides (`weather/domain.py`), the existing kernels launched on
each shard's padded slab (hadv in its passthrough mode, the dycore from the
staggered sum built on the slab), and the interior crop.

Each op also declares its models, as the JAX package's do: the analytic
window `report()["model"]` estimates (`model_tile`), the modelled bytes of
a step (`traffic`, from `core/memmodel.py`), the wire bytes of a packed
exchange at depth k over a mesh (`exchange_model`; a single-device plan
has none), the CUDA k-step legality `autotune.resolve_k_steps` walks
(`kstep_check`), and the kernel tiles `compile(tune="measure")` times
(`cuda_tile_candidates`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import autotune, memmodel, tiling
from repro_torch.core.hwspec import dtype_bytes
from repro_torch.core.spans import LOWERING, contiguous, copied, spanned
from repro_torch.kernels.dycore_fused import ops as fused_ops
from repro_torch.kernels.dycore_fused.ref import pad_periodic
from repro_torch.kernels.hadv import ops as hadv_ops
from repro_torch.kernels.hadv import ref as hadv_ref
from repro_torch.kernels.hdiff import ops as hdiff_ops
from repro_torch.kernels.hdiff import ref as hdiff_ref
from repro_torch.kernels.vadvc import ops as vadvc_ops
from repro_torch.kernels.vadvc import ref as vadvc_ref
from repro_torch.weather import domain as _domain
from repro_torch.weather import dycore as _dycore
from repro_torch.weather.dycore import HALO
from repro_torch.weather.fields import WeatherState, dtype_name, field_views

VARIANTS = ("auto", "unfused", "per_field", "whole_state", "kstep")

# Useful flops per output point and step (the JAX package's tile specs).
DYCORE_FLOPS_PER_POINT = 61.0
HDIFF_FLOPS_PER_POINT = 21.0
VADVC_FLOPS_PER_POINT = 38.0
HADV_UPWIND_FLOPS_PER_POINT = 5.0
VADVC_UPDATE_FLOPS_PER_POINT = 40.0
ASSELIN_FLOPS_PER_POINT = 3.0


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

    * `resolve_tile(variant, compute_grid, dtype, n_fields, ensemble, k,
      request=None)` -> `tiling.CudaTile`, or None for the unfused oracle
      variant; a `(ty, tx)` request pins the kernel planner's arguments;
    * `build_local_step(plan)` -> `state -> state`, the single-device round;
    * `build_shard_local(plan)` -> `(fields, wcon, tens, stage_tens) ->
      (new_fields, new_stage)`, the round on a mesh: each argument a list
      in shard order (of dicts, or of wcon tensors) of the shards' local
      slabs; the exchange of the plan's schedule (`weather/domain.py`),
      the op's launches on each shard, and the interior crop;
    * `collectives(variant, n_fields, py, px, k)` -> rides a round on a
      mesh, or None to derive them from the rides (`generic_collectives`);
    * `apply_stage(prog, names, use_ref)` -> the op's full-slab stage
      function `(fields, wconp, tens, stage_tens) -> (new_fields,
      new_stage)` of one shard for the pipeline's mesh round: dict values
      are padded slabs, `names` the stage's bound fields; no exchange and
      no crop (the chain's round owns both);
    * `pallas_calls(variant, n_fields, k)` -> kernel launches per round
      (the JAX package's key name, kept for schema parity);
    * `model_tile(variant, compute_grid, dtype, n_fields, ensemble, k)` ->
      the analytic model's `tiling.TilePlan` window over the variant's tile
      space (`tile_spaces`), or None for the oracle: what
      `report()["model"]` estimates, never what a launch takes;
    * `traffic(plan, model_ty)` -> `report()["traffic"]`, the modelled
      bytes of a step at a `model_ty`-row window of the physical grid;
    * `exchange_model(program, k, shards)` -> the modelled wire bytes of
      the op's packed exchange at depth k over `shards` = (py, px);
    * `kstep_check(program, shards)` -> a callable that raises ValueError
      for a k the op's CUDA k-step round refuses (for
      `autotune.resolve_k_steps`);
    * `cuda_tile_candidates(variant, compute_grid, dtype, n_fields, k)` ->
      `[(request, CudaTile), ...]`, the kernel tiles
      `compile(tune="measure")` times: the default tile first, then one a
      distinct tile, each with the request that pins it;
    * `chainable`: whether the op may be a stage of a pipeline chain
      (`weather/pipeline.py`), which runs its solo step over the stage's
      bound fields; the JAX package's ops with an `apply_stage` lowering.
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
    tile_spaces: Tuple[Tuple[str, str], ...] = ()  # (variant, autotune op)
    resolve_tile: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    build_local_step: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    build_shard_local: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    collectives: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    apply_stage: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    pallas_calls: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    model_tile: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    traffic: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    exchange_model: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    kstep_check: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    cuda_tile_candidates: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    chainable: bool = False                  # may be a pipeline stage

    def resolved_rides(self, k: int):
        """((operand, (y_lo, y_hi), (x_lo, x_hi)), ...) at depth k."""
        return tuple((r.operand,) + r.depths(k) for r in self.rides)

    def memmodel_rides(self, n_fields: int):
        """The rides in `memmodel.packed_exchange_model` form."""
        return tuple((r.operand, n_fields if r.per_field else 1,
                      r.y, r.x, r.y_fixed, r.x_fixed) for r in self.rides)

    def generic_collectives(self, py: int, px: int, k: int) -> int:
        """Rides a packed round, from the footprint: one a mesh direction
        and side any operand rides (a side nothing rides is elided by
        `domain._exchange_packed`)."""
        total = 0
        for axis, n in (("y", py), ("x", px)):
            if n <= 1:
                continue
            lo = hi = False
            for r in self.rides:
                dy, dx = r.depths(k)
                d = dy if axis == "y" else dx
                lo |= d[0] > 0
                hi |= d[1] > 0
            total += int(lo) + int(hi)
        return total

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


def _tile_candidates(resolve, default_request, requests
                     ) -> List[Tuple[Tuple[int, int], tiling.CudaTile]]:
    """`[(request, tile), ...]` for `cuda_tile_candidates`: the default
    request first, then each of `requests` whose tile the kernel's planner
    accepts (a ValueError drops it) and no earlier request gave. `resolve`
    maps a `(ty, tx)` request, or None for the default, to a tile."""
    default = resolve(None)
    if resolve(default_request) != default:
        raise RuntimeError(f"the request {default_request} does not pin "
                           f"the default tile {default}")
    out, seen = [(tuple(default_request), default)], {default}
    for request in requests:
        try:
            tile = resolve(tuple(request))
        except ValueError:
            continue
        if tile not in seen:
            seen.add(tile)
            out.append((tuple(request), tile))
    return out


def _mesh_of(plan):
    """`(mesh, ax_y, ax_x, wire dtype)` of a mesh plan."""
    _, ax_y, ax_x = plan.mesh_axes
    return plan.mesh, ax_y, ax_x, plan.program.exchange_dtype


@spanned("nero.lower.stack")
def _stack(d: dict, names) -> torch.Tensor:
    """`dycore.stack_state` for the lowering: in span `nero.lower.stack`,
    and counted in `LOWERING` when it copies (not when it is a view)."""
    out = _dycore.stack_state(d, names)
    return out if out._is_view() else copied(out)


@spanned("nero.lower.pad")
def _pad(f: torch.Tensor, halo: int) -> torch.Tensor:
    """`pad_periodic` for the lowering: in span `nero.lower.pad`, and its
    two cats counted in `LOWERING` (the rows padded, then the columns)."""
    out = pad_periodic(f, halo)
    LOWERING["copies"] += 2
    LOWERING["bytes"] += out.nbytes // out.shape[-1] * f.shape[-1] \
        + out.nbytes
    return out


def _crop(a: torch.Tensor, y0: int, ly: int, x0: int, lx: int):
    """The interior `(ly, lx)` of a padded slab from `(y0, x0)`, as a new
    contiguous tensor (the next round stacks it without a copy)."""
    return contiguous(a[..., y0:y0 + ly, x0:x0 + lx])


def _generic_exchange_model(program, k, shards):
    """The packed exchange of any op, from its declared rides."""
    op = get_stencil_op(program.op)
    return memmodel.packed_exchange_model(
        program.grid_shape, program.dtype,
        rides=op.memmodel_rides(program.n_fields), k=k, shards=shards,
        compute_halo=(k * op.halo, k * op.halo),
        exchange_dtype=program.exchange_dtype)


# ---------------------------------------------------------------------------
# "dycore" — the fused compound step
# ---------------------------------------------------------------------------


def _dycore_resolve_tile(variant, compute_grid, dtype, n_fields, ensemble,
                         k, request=None):
    if variant == "unfused":
        return None
    nz, ny, nx = compute_grid
    ty, tx = request or (None, None)
    if variant == "kstep":
        return tiling.dycore_kstep_tile(ny, nx, k, ty, tx, nz=nz)
    # per_field launches one field at a time: no fields to share w's
    # sweep coefficients, a cluster of one
    return tiling.dycore_tile(ny, nx, ty, tx, nz=nz,
                              nf=1 if variant == "per_field" else n_fields)


def _dycore_cuda_tile_candidates(variant, compute_grid, dtype, n_fields, k):
    if variant == "unfused":
        return []
    resolve = lambda req: _dycore_resolve_tile(
        variant, compute_grid, dtype, n_fields, 1, k, req)
    if variant == "kstep":
        default = resolve(None)
        return _tile_candidates(resolve, (default.ty, default.tx),
                                tiling.DYCORE_KSTEP_TILES)
    nf = 1 if variant == "per_field" else n_fields
    return _tile_candidates(resolve, tiling.dycore_default(nf),
                            tiling.FUSED_TILES)


def _dycore_model_tile(variant, compute_grid, dtype, n_fields, ensemble, k):
    ty = fused_ops.resolve_tile(variant, compute_grid, dtype, n_fields, k)
    if ty is None:
        return None
    spec = {"per_field": tiling.DYCORE_FUSED,
            "whole_state": tiling.dycore_whole_state_spec(n_fields),
            "kstep": tiling.dycore_kstep_spec(n_fields, k)}[variant]
    return tiling.TilePlan(op=spec, grid_shape=tuple(compute_grid),
                           tile=(compute_grid[0], ty, compute_grid[2]),
                           dtype=dtype_name(dtype))


def _dycore_traffic(plan, model_ty):
    prog = plan.program
    return memmodel.dycore_step_traffic(
        prog.grid_shape, prog.dtype, n_fields=prog.n_fields, ty=model_ty,
        k_steps=plan.k_steps)


def _dycore_exchange_model(program, k, shards):
    return memmodel.kstep_exchange_model(
        program.grid_shape, program.dtype, n_fields=program.n_fields, k=k,
        shards=shards, halo=HALO, exchange_dtype=program.exchange_dtype)


def _dycore_kstep_check(program, shards):
    """The k-step kernel's tile on the k-padded local slab at the grid's
    nz (`autotune.resolve_k_steps`'s default)."""
    return autotune.dycore_kstep_check(program.grid_shape, shards, HALO)


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
                    contiguous(state.fields[name]), contiguous(state.wcon),
                    contiguous(state.tens[name]),
                    contiguous(state.stage_tens[name]), coeff=coeff, dt=dt,
                    tile=tile)
            return _new_state(state, new_fields, new_stage)
        return step

    stack = lambda d: _stack(d, names)
    unstack = lambda a: _dycore.unstack_state(a, names)

    if variant == "whole_state":
        def step(state: WeatherState) -> WeatherState:
            f_new, stage = fused_ops.fused_step_whole_state(
                stack(state.fields), contiguous(state.wcon),
                stack(state.tens), stack(state.stage_tens), coeff=coeff,
                dt=dt, tile=tile)
            return _new_state(state, unstack(f_new), unstack(stage))
        return step

    k = plan.k_steps

    def step(state: WeatherState) -> WeatherState:    # kstep: ONE launch
        f_new, stage = fused_ops.fused_step_kstep(
            stack(state.fields), contiguous(state.wcon), stack(state.tens),
            stack(state.stage_tens), k_steps=k, coeff=coeff, dt=dt,
            tile=tile)
        return _new_state(state, unstack(f_new), unstack(stage))
    return step


def _dycore_shard_local(plan):
    """The dycore's round on a mesh, per the plan's exchange schedule:

    * `unfused`: per field, the plain vadvc with wcon's right column from
      the x neighbour, the update, and the plain hdiff on the exchanged
      slab (`domain._local_vadvc`, `domain._local_hdiff`);
    * `per_field`: the staggered sum built once and exchanged, then per
      field its three operands exchanged and one whole-state kernel launch
      at one field on the padded slab;
    * `whole_state` / `kstep`: ONE packed exchange per direction of every
      operand (fields, tendencies, stage tendencies at the round's reach
      and wcon at its ragged `(hx, hx + 1)` x-depth: the staggering column
      comes from the right neighbour only), the staggered sum
      `w = wconp[..., :-1] + wconp[..., 1:]` on the padded slab (valid to
      its edge, which the kernel's periodic `staggered_w` would not be),
      one launch of the whole-state or k-step kernel a shard, and the
      crop."""
    prog = plan.program
    mesh, ax_y, ax_x, wire = _mesh_of(plan)
    names = prog.fields
    coeff, dt, k, tile = prog.coeff, prog.dt, plan.k_steps, plan.tile
    col = lambda ds, n: [d[n] for d in ds]

    def local_unfused(fields, wcon, tens, stage_tens):
        new_fields = [{} for _ in wcon]
        new_stage = [{} for _ in wcon]
        for name in names:
            f = col(fields, name)
            stage = _domain._local_vadvc(f, wcon, f, col(tens, name),
                                         col(stage_tens, name), mesh, ax_x)
            f = [a + dt * b for a, b in zip(f, stage)]
            f = _domain._local_hdiff(f, coeff, mesh, ax_y, ax_x)
            for s in range(len(wcon)):
                new_fields[s][name] = f[s]
                new_stage[s][name] = stage[s]
        return new_fields, new_stage

    def local_per_field(fields, wcon, tens, stage_tens):
        ly, lx = wcon[0].shape[-2:]

        def pad(xs):
            xs = _domain._exchange(xs, mesh, ax_y, HALO, dim=2)
            return _domain._exchange(xs, mesh, ax_x, HALO, dim=3)

        # one exchange of the pre-combined staggered velocity serves every
        # field; each field's inputs are exchanged so the halo ring's vadvc
        # tendency is recomputed locally
        wp = pad(_domain._staggered_w(wcon, mesh, ax_x))
        new_fields = [{} for _ in wcon]
        new_stage = [{} for _ in wcon]
        one = lambda a: a.unsqueeze(-4)
        for name in names:
            fp, tp, sp = (pad(col(d, name))
                          for d in (fields, tens, stage_tens))
            for s, (f, w, t, st) in enumerate(zip(fp, wp, tp, sp)):
                f_new, stage = fused_ops.fused_step_summed(
                    one(f), w, one(t), one(st), coeff=coeff, dt=dt,
                    tile=tile)
                new_fields[s][name] = _crop(f_new.squeeze(-4), HALO, ly,
                                            HALO, lx)
                new_stage[s][name] = _crop(stage.squeeze(-4), HALO, ly,
                                           HALO, lx)
        return new_fields, new_stage

    def local_packed(fields, wcon, tens, stage_tens):
        ly, lx = wcon[0].shape[-2:]
        sched = plan.exchange
        hy, hx = sched.depth_y, sched.depth_x
        stk = lambda ds: [_stack(d, names) for d in ds]
        # the three stacks and wcon share one wire buffer a direction
        parts = _domain._exchange_packed(
            [(stk(fields), hy), (stk(tens), hy), (stk(stage_tens), hy),
             (wcon, hy)], mesh, ax_y, dim=-2, wire_dtype=wire)
        fs, ts, ss, wp = _domain._exchange_packed(
            [(parts[0], hx), (parts[1], hx), (parts[2], hx),
             (parts[3], sched.wcon_depth_x)], mesh, ax_x, dim=-1,
            wire_dtype=wire)
        new_fields, new_stage = [], []
        for f, t, st, wc in zip(fs, ts, ss, wp):
            w = wc[..., :-1] + wc[..., 1:]
            if k == 1:
                f, st = fused_ops.fused_step_summed(f, w, t, st, coeff=coeff,
                                                    dt=dt, tile=tile)
            else:               # the whole round in one launch
                f, st = fused_ops.fused_kstep_summed(f, w, t, st, k_steps=k,
                                                     coeff=coeff, dt=dt,
                                                     tile=tile)
            new_fields.append(field_views(_crop(f, hy, ly, hx, lx), names))
            new_stage.append(field_views(_crop(st, hy, ly, hx, lx), names))
        return new_fields, new_stage

    return {"unfused": local_unfused, "per_field": local_per_field,
            "whole_state": local_packed, "kstep": local_packed}[plan.variant]


def _dycore_collectives(variant, n_fields, py, px, k):
    if variant in ("whole_state", "kstep"):
        return None          # from the rides: one pair a direction
    ey = 2 if py > 1 else 0  # one ride pair an active direction
    ex = 2 if px > 1 else 0
    rc = 1 if px > 1 else 0  # wcon's right-column fetch
    if variant == "per_field":
        # the shared staggered-w pad + 3 per-operand pads a field
        return rc + (ey + ex) + n_fields * 3 * (ey + ex)
    # unfused: per-field vadvc + hdiff pads
    return n_fields * (rc + ey + ex)


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
    tile_spaces=(("per_field", "dycore_fused"),
                 ("whole_state", "dycore_whole_state"),
                 ("kstep", "dycore_kstep")),
    resolve_tile=_dycore_resolve_tile,
    build_local_step=_dycore_local_step,
    build_shard_local=_dycore_shard_local,
    collectives=_dycore_collectives,
    pallas_calls=lambda variant, nf, k: {"unfused": 0, "per_field": nf,
                                         "whole_state": 1, "kstep": 1}[
                                             variant],
    model_tile=_dycore_model_tile,
    traffic=_dycore_traffic,
    exchange_model=_dycore_exchange_model,
    kstep_check=_dycore_kstep_check,
    cuda_tile_candidates=_dycore_cuda_tile_candidates,
))


# ---------------------------------------------------------------------------
# "hdiff" — compound horizontal diffusion alone
# ---------------------------------------------------------------------------


def _hdiff_resolve_tile(variant, compute_grid, dtype, n_fields, ensemble,
                        k, request=None):
    if variant == "unfused":
        return None
    ty, tx = request or (None, None)
    if variant == "whole_state":
        # the periodic launch runs on the unpadded planes
        return tiling.hdiff_tile(compute_grid[1] - 2 * hdiff_ops.HALO,
                                 compute_grid[2] - 2 * hdiff_ops.HALO, ty, tx,
                                 periodic=True)
    return tiling.hdiff_kstep_tile(compute_grid[1], compute_grid[2],
                                   k if variant == "kstep" else 1, ty, tx)


def _hdiff_cuda_tile_candidates(variant, compute_grid, dtype, n_fields, k):
    if variant == "unfused":
        return []
    resolve = lambda req: _hdiff_resolve_tile(
        variant, compute_grid, dtype, n_fields, 1, k, req)
    default = resolve(None)
    return _tile_candidates(resolve, (default.ty, default.tx),
                            tiling.HDIFF_TILES)


def _hdiff_model_tile(variant, compute_grid, dtype, n_fields, ensemble, k):
    if variant == "unfused":
        return None
    return hdiff_ops.resolve_tile(compute_grid, dtype)


def _plane_traffic(spec_name: str):
    """The `traffic` hook of a plane-wise op (hdiff, hadv_upwind, asselin):
    one plane, `model_ty` rows, the whole x extent."""
    def traffic(plan, model_ty):
        prog = plan.program
        nz, ny, nx = prog.grid_shape
        # model_ty may come from the padded compute grid; the model runs on
        # the physical grid, so snap to a legal window of it
        tile = (1, tiling.snap_to_divisor(model_ty, ny, lo=1), nx)
        return memmodel.stencil_op_traffic(
            autotune.get_op(spec_name), prog.grid_shape, prog.dtype,
            n_fields=prog.n_fields, tile=tile, k_steps=plan.k_steps)
    return traffic


def _hdiff_local_step(plan):
    """Single-device hdiff round. The whole-state round on the card makes
    ONE periodic launch (the fully z-parallel stencil folds (ensemble,
    field, z) into the kernel's plane axis) on the field-stacked state and
    returns a new contiguous field-stacked state, which the next round
    stacks without a copy: the wrap the JAX package gets from its packed
    exchange is read inside the kernel, with the bits of wrap-padding by 2,
    the passthrough step and the interior crop. Every other round wrap-pads
    by the round's reach, `k·2`, runs the plain step (the oracle, and the
    whole-state round on the CPU, which has no kernel to read the wrap),
    one launch a field or ONE k-step launch, and crops the interior. The
    k-step round is bit-equal to k whole-state rounds: each in-kernel step
    rounds through the storage dtype, and the crop keeps only points the k
    steps left exact. The compute grid the plan reports is padded, as the
    JAX package reports it."""
    prog = plan.program
    names, coeff, variant, tile = prog.fields, prog.coeff, plan.variant, \
        plan.tile
    k = plan.k_steps
    halo = k * HALO

    def step(state: WeatherState) -> WeatherState:
        fs = _stack(state.fields, names)   # (e, nf, nz, ly, lx)
        if variant == "whole_state" and fs.is_cuda:
            out = hdiff_ops.hdiff(fs.reshape((-1,) + fs.shape[-2:]),
                                  coeff=coeff, tile=tile, periodic=True)
            return _new_state(
                state, _dycore.unstack_state(out.reshape(fs.shape), names),
                dict(state.stage_tens))
        ly, lx = fs.shape[-2:]
        fs = _pad(fs, halo)
        Y, X = fs.shape[-2:]
        if variant == "unfused":
            out = hdiff_ref.hdiff(fs.reshape(-1, Y, X), coeff=coeff)
        elif variant == "per_field":
            out = torch.stack(
                [hdiff_ops.hdiff(fs[:, i].reshape(-1, Y, X), coeff=coeff,
                                 tile=tile).reshape(fs[:, i].shape)
                 for i in range(len(names))], dim=1)
        elif variant == "whole_state":               # the plain step
            out = hdiff_ops.hdiff(fs.reshape(-1, Y, X), coeff=coeff)
        else:                                        # kstep: ONE launch
            out = hdiff_ops.hdiff_kstep(fs.reshape(-1, Y, X), coeff=coeff,
                                        k=k, tile=tile)
        out = out.reshape(fs.shape)[..., halo:halo + ly, halo:halo + lx]
        return _new_state(state, {n: out[:, i] for i, n in enumerate(names)},
                          dict(state.stage_tens))
    return step


def _hdiff_shard_local(plan):
    """hdiff's round on a mesh, every variant: ONE packed exchange per
    direction at the round's reach `k·2`, then the launches on each shard's
    padded stack (the plain version, one a field, one for the whole state,
    or one k-step launch for the round), in the kernel's passthrough mode,
    and the crop. On a `(1, 1)` mesh the exchange is the single-device
    step's wrap padding. The whole-state plan's tile was planned for the
    unpadded slab; the launch re-balances it over the padded one (the
    kernel is bit for bit tile-independent)."""
    prog = plan.program
    mesh, ax_y, ax_x, wire = _mesh_of(plan)
    names, coeff, variant, tile = prog.fields, prog.coeff, plan.variant, \
        plan.tile
    k = plan.k_steps
    (_, (hy_lo, hy_hi), (hx_lo, hx_hi)), = plan.rides

    def local(fields, wcon, tens, stage_tens):
        fs = [_stack(d, names) for d in fields]
        ly, lx = fs[0].shape[-2:]
        (fs,) = _domain._exchange_packed([(fs, (hy_lo, hy_hi))], mesh, ax_y,
                                         dim=-2, wire_dtype=wire)
        (fs,) = _domain._exchange_packed([(fs, (hx_lo, hx_hi))], mesh, ax_x,
                                         dim=-1, wire_dtype=wire)
        new_fields = []
        for a in fs:
            Y, X = a.shape[-2:]
            planes = a.reshape(-1, Y, X)
            if variant == "unfused":
                out = hdiff_ref.hdiff(planes, coeff=coeff)
            elif variant == "per_field":
                out = torch.stack(
                    [hdiff_ops.hdiff(a[:, i].reshape(-1, Y, X), coeff=coeff,
                                     tile=tile).reshape(a[:, i].shape)
                     for i in range(len(names))], dim=1)
            elif variant == "whole_state":
                out = hdiff_ops.hdiff(planes, coeff=coeff,
                                      tile=tiling.hdiff_tile(Y, X, tile.ty,
                                                             tile.tx))
            else:                                    # kstep: ONE launch
                out = hdiff_ops.hdiff_kstep(planes, coeff=coeff, k=k,
                                            tile=tile)
            new_fields.append(field_views(
                _crop(out.reshape(a.shape), hy_lo, ly, hx_lo, lx), names))
        return new_fields, [dict(d) for d in stage_tens]
    return local


def _hdiff_apply_stage(prog, names, use_ref):
    """hdiff as a chain stage on one shard's padded slabs: the bound
    fields' planes in one launch (the kernel's own tile for the slab)."""
    coeff = prog.coeff

    def fn(fields, wconp, tens, stage_tens):
        fs = _stack(fields, names)
        planes = fs.reshape((-1,) + fs.shape[-2:])
        out = (hdiff_ref.hdiff(planes, coeff=coeff) if use_ref
               else hdiff_ops.hdiff(planes, coeff=coeff)).reshape(fs.shape)
        return ({**fields, **{n: out[:, i] for i, n in enumerate(names)}},
                dict(stage_tens))
    return fn


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
    tile_spaces=(("per_field", "hdiff"), ("whole_state", "hdiff"),
                 ("kstep", "hdiff")),
    resolve_tile=_hdiff_resolve_tile,
    build_local_step=_hdiff_local_step,
    build_shard_local=_hdiff_shard_local,
    apply_stage=_hdiff_apply_stage,
    pallas_calls=lambda variant, nf, k: {"unfused": 0, "per_field": nf,
                                         "whole_state": 1, "kstep": 1}[
                                             variant],
    model_tile=_hdiff_model_tile,
    traffic=_plane_traffic("hdiff"),
    exchange_model=_generic_exchange_model,
    # every k runs: a round of more than tiling.HDIFF_MAX_K steps runs as
    # several launches, each planning its own tile
    kstep_check=lambda program, shards: (lambda k: None),
    cuda_tile_candidates=_hdiff_cuda_tile_candidates,
    chainable=True,
))


# ---------------------------------------------------------------------------
# "vadvc" — vertical advection alone
# ---------------------------------------------------------------------------


def _vadvc_resolve_tile(variant, compute_grid, dtype, n_fields, ensemble,
                        k, request=None):
    if variant == "unfused":
        return None
    nz, ny, nx = compute_grid
    # a warp owns one row: a request's ty is not the kernel's to take
    cols = None if request is None else request[1]
    return tiling.vadvc_tile(ny, nx, nz, dtype_bytes(dtype), cols)


def _vadvc_cuda_tile_candidates(variant, compute_grid, dtype, n_fields, k):
    if variant == "unfused":
        return []
    resolve = lambda req: _vadvc_resolve_tile(
        variant, compute_grid, dtype, n_fields, 1, k, req)
    return _tile_candidates(resolve, (1, resolve(None).tx),
                            [(1, cols) for cols in tiling.VADVC_TILES])


def _vadvc_fold_grid(variant, local_grid, n_fields, ensemble):
    """The grid the JAX package's vadvc kernel tiles: the horizontally
    parallel sweep folds (ensemble [, field]) into y."""
    nz, ly, lx = local_grid
    fold = ensemble * (n_fields if variant == "whole_state" else 1)
    return (nz, fold * ly, lx)


def _vadvc_model_tile(variant, compute_grid, dtype, n_fields, ensemble, k):
    if variant == "unfused":
        return None
    return vadvc_ops.resolve_tile(
        _vadvc_fold_grid(variant, compute_grid, n_fields, ensemble), dtype)


def _sweep_traffic(spec_name: str):
    """The `traffic` hook of a z-sweep op (vadvc, vadvc_update)."""
    def traffic(plan, model_ty):
        prog = plan.program
        nz, ny, nx = prog.grid_shape
        # the model's window lives on the ensemble/field-folded grid; the
        # model runs on the physical grid, so snap its (tj, ti) to legal
        # extents of (ny, nx) (z whole: the sweep is sequential)
        window = plan.model_window()
        tj, ti = (model_ty, nx) if window is None else window.tile[1:]
        tile = (nz, tiling.snap_to_divisor(tj, ny, lo=1),
                tiling.snap_to_divisor(ti, nx, lo=1))
        return memmodel.stencil_op_traffic(
            autotune.get_op(spec_name), prog.grid_shape, prog.dtype,
            n_fields=prog.n_fields, tile=tile, k_steps=plan.k_steps)
    return traffic


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
                u = contiguous(state.fields[n])
                new_stage[n] = vadvc_ops.vadvc(
                    u, wcon, u, contiguous(state.tens[n]),
                    contiguous(state.stage_tens[n]), tile=tile)
        else:                                        # whole_state
            stack = lambda d: _stack(d, names)
            u = stack(state.fields)
            out = vadvc_ops.vadvc(u, wcon, u, stack(state.tens),
                                  stack(state.stage_tens), tile=tile)
            new_stage = _dycore.unstack_state(out, names)
        return _new_state(state, dict(state.fields), new_stage)
    return step


def _vadvc_shard_local(plan, update: bool = False):
    """vadvc's round on a mesh: the only operand that rides is wcon's
    right staggering column, the `(0, 1)` x-ride (ONE ride; the other
    direction ships nothing and is elided); fields and tendencies need no
    halo, so there is no crop. The kernel takes the staggered `(.., lx +
    1)` wcon once for every field under it: per_field launches once a
    field, whole_state once over the stack. With `update` (the
    vadvc_update op), then `f + dt * stage` on the stack."""
    prog = plan.program
    mesh, ax_y, ax_x, wire = _mesh_of(plan)
    names, variant, tile, dt = prog.fields, plan.variant, plan.tile, prog.dt
    (_, _, (wx_lo, wx_hi)), = plan.rides

    def local(fields, wcon, tens, stage_tens):
        (wconp,) = _domain._exchange_packed([(wcon, (wx_lo, wx_hi))], mesh,
                                            ax_x, dim=-1, wire_dtype=wire)
        new_fields, new_stage = [], []
        for fd, w, td, sd in zip(fields, wconp, tens, stage_tens):
            if variant == "per_field":
                stage = {}
                for n in names:
                    u = contiguous(fd[n])
                    stage[n] = vadvc_ops.vadvc(u, w, u, contiguous(td[n]),
                                               contiguous(sd[n]), tile=tile)
                new_fields.append(dict(fd))
                new_stage.append(stage)
                continue
            stack = lambda d: _stack(d, names)
            u, ts, ss = stack(fd), stack(td), stack(sd)
            if variant == "unfused":
                ss = vadvc_ref.vadvc(u, w.unsqueeze(1), u, ts, ss)
            else:
                ss = vadvc_ops.vadvc(u, w, u, ts, ss, tile=tile)
            new_stage.append(field_views(ss, names))
            new_fields.append(field_views(u + dt * ss, names) if update
                              else dict(fd))
        return new_fields, new_stage
    return local


def _vadvc_apply_stage(prog, names, use_ref, update: bool = False):
    """vadvc (with `update`, vadvc_update) as a chain stage on one shard's
    padded slabs: one launch over the bound fields' stack; `wconp` is one
    column wider on the high-x side than the field slabs, the solo round's
    staggering contract."""
    dt = prog.dt

    def fn(fields, wconp, tens, stage_tens):
        u, ts, ss = (_stack(d, names)
                      for d in (fields, tens, stage_tens))
        ss = (vadvc_ref.vadvc(u, wconp.unsqueeze(1), u, ts, ss) if use_ref
              else vadvc_ops.vadvc(u, wconp, u, ts, ss))
        new_stage = {**stage_tens,
                     **{n: ss[:, i] for i, n in enumerate(names)}}
        if not update:
            return dict(fields), new_stage
        fs = u + dt * ss
        return ({**fields, **{n: fs[:, i] for i, n in enumerate(names)}},
                new_stage)
    return fn


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
    tile_spaces=(("per_field", "vadvc"), ("whole_state", "vadvc")),
    resolve_tile=_vadvc_resolve_tile,
    build_local_step=_vadvc_local_step,
    build_shard_local=_vadvc_shard_local,
    apply_stage=_vadvc_apply_stage,
    pallas_calls=lambda variant, nf, k: {"unfused": 0, "per_field": nf,
                                         "whole_state": 1}[variant],
    model_tile=_vadvc_model_tile,
    traffic=_sweep_traffic("vadvc"),
    exchange_model=_generic_exchange_model,
    cuda_tile_candidates=_vadvc_cuda_tile_candidates,
    chainable=True,
))


# ---------------------------------------------------------------------------
# "vadvc_update" — vadvc and the point-wise update (no hdiff)
# ---------------------------------------------------------------------------


def _vadvc_update_model_tile(variant, compute_grid, dtype, n_fields, ensemble,
                             k):
    """The JAX package's window: vadvc's on the (ensemble, field)-folded
    grid, in `VADVC_UPDATE`'s tile space."""
    if variant == "unfused":
        return None
    tj, ti = vadvc_ops.plan_tile(
        _vadvc_fold_grid("whole_state", compute_grid, n_fields, ensemble),
        dtype)
    return tiling.TilePlan(op=autotune.get_op("vadvc_update"),
                           grid_shape=tuple(int(g) for g in compute_grid),
                           tile=(int(compute_grid[0]), tj, ti),
                           dtype=dtype_name(dtype))


def _vadvc_update_local_step(plan):
    """Single-device vadvc_update round: the whole-state vadvc step (one
    launch over the field-stacked state with the state's periodic wcon,
    or the plain version), then `f + dt * stage` on the stack."""
    prog = plan.program
    names, dt, tile = prog.fields, prog.dt, plan.tile
    use_ref = plan.variant == "unfused"

    def step(state: WeatherState) -> WeatherState:
        stack = lambda d: _stack(d, names)
        u, ts, ss = (stack(state.fields), stack(state.tens),
                     stack(state.stage_tens))
        if use_ref:
            ss = vadvc_ref.vadvc(u, state.wcon.unsqueeze(1), u, ts, ss)
        else:
            ss = vadvc_ops.vadvc(u, state.wcon, u, ts, ss, tile=tile)
        return _new_state(state, _dycore.unstack_state(u + dt * ss, names),
                          _dycore.unstack_state(ss, names))
    return step


register_stencil_op(StencilOpDef(
    name="vadvc_update",
    title="vertical advection + fused point-wise update (no hdiff)",
    reads=("fields", "wcon", "tens", "stage_tens"),
    writes=("fields", "stage_tens"),
    halo=0,
    flops_per_point=VADVC_UPDATE_FLOPS_PER_POINT,
    rides=(OperandRide("wcon", x_fixed=(0, 1)),),
    variants=("unfused", "whole_state"),
    inkernel_kstep=False,
    pads_single_chip=True,
    packed_variants=("unfused", "whole_state"),
    tile_spaces=(("whole_state", "vadvc_update"),),
    resolve_tile=_vadvc_resolve_tile,
    build_local_step=_vadvc_update_local_step,
    build_shard_local=lambda plan: _vadvc_shard_local(plan, update=True),
    apply_stage=lambda prog, names, use_ref: _vadvc_apply_stage(
        prog, names, use_ref, update=True),
    pallas_calls=lambda variant, nf, k: {"unfused": 0,
                                         "whole_state": 1}[variant],
    model_tile=_vadvc_update_model_tile,
    traffic=_sweep_traffic("vadvc_update"),
    exchange_model=_generic_exchange_model,
    cuda_tile_candidates=_vadvc_cuda_tile_candidates,
    chainable=True,
))


# ---------------------------------------------------------------------------
# "hadv_upwind" — first-order upwind horizontal advection (backward-only
# reach: the registry's asymmetric-ride op)
# ---------------------------------------------------------------------------


def _hadv_resolve_tile(variant, compute_grid, dtype, n_fields, ensemble, k,
                       request=None):
    if variant == "unfused":
        return None
    ty, tx = request or (None, None)
    # the kernel runs on the unpadded planes
    return tiling.hadv_tile(compute_grid[1] - 2 * hadv_ops.HALO,
                            compute_grid[2] - 2 * hadv_ops.HALO,
                            dtype_bytes(dtype), ty, tx)


def _hadv_cuda_tile_candidates(variant, compute_grid, dtype, n_fields, k):
    if variant == "unfused":
        return []
    resolve = lambda req: _hadv_resolve_tile(
        variant, compute_grid, dtype, n_fields, 1, k, req)
    default = resolve(None)
    return _tile_candidates(resolve, (default.ty, default.tx),
                            tiling.HADV_TILES)


def _hadv_model_tile(variant, compute_grid, dtype, n_fields, ensemble, k):
    if variant == "unfused":
        return None
    return hadv_ops.resolve_tile(compute_grid, dtype)


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
        fs = _stack(state.fields, names)   # (e, nf, nz, ly, lx)
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


def _hadv_shard_local(plan):
    """hadv's round on a mesh: ONE packed exchange per direction at the
    asymmetric `(1, 0)` depth (the donor cell looks backward only, so the
    high sides ship nothing and that direction is elided), the kernel in
    its passthrough mode on each shard's padded stack (row 0 and column 0,
    the pad, pass through), and the crop. The plan's tile was planned for
    the unpadded slab; the launch re-balances it over the padded one (the
    kernel is bit for bit tile-independent)."""
    prog = plan.program
    mesh, ax_y, ax_x, wire = _mesh_of(plan)
    names, cfl, variant, tile = prog.fields, prog.coeff, plan.variant, \
        plan.tile
    (_, (hy_lo, hy_hi), (hx_lo, hx_hi)), = plan.rides

    def local(fields, wcon, tens, stage_tens):
        fs = [_stack(d, names) for d in fields]
        ly, lx = fs[0].shape[-2:]
        (fs,) = _domain._exchange_packed([(fs, (hy_lo, hy_hi))], mesh, ax_y,
                                         dim=-2, wire_dtype=wire)
        (fs,) = _domain._exchange_packed([(fs, (hx_lo, hx_hi))], mesh, ax_x,
                                         dim=-1, wire_dtype=wire)
        new_fields = []
        for a in fs:
            Y, X = a.shape[-2:]
            planes = a.reshape(-1, Y, X)
            if variant == "unfused":
                out = hadv_ref.hadv_upwind(planes, cfl=cfl)
            else:
                slab_tile = tiling.hadv_tile(Y, X, a.element_size(), tile.ty,
                                             tile.tx)
                out = hadv_ops.hadv_upwind(planes, cfl=cfl, tile=slab_tile)
            new_fields.append(field_views(
                _crop(out.reshape(a.shape), hy_lo, ly, hx_lo, lx), names))
        return new_fields, [dict(d) for d in stage_tens]
    return local


def _hadv_apply_stage(prog, names, use_ref):
    """hadv as a chain stage on one shard's padded slabs: passthrough mode
    over the bound fields' planes, the kernel's own tile for the slab."""
    cfl = prog.coeff

    def fn(fields, wconp, tens, stage_tens):
        fs = _stack(fields, names)
        planes = fs.reshape((-1,) + fs.shape[-2:])
        out = (hadv_ref.hadv_upwind(planes, cfl=cfl) if use_ref
               else hadv_ops.hadv_upwind(planes, cfl=cfl)).reshape(fs.shape)
        return ({**fields, **{n: out[:, i] for i, n in enumerate(names)}},
                dict(stage_tens))
    return fn


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
    tile_spaces=(("whole_state", "hadv_upwind"),),
    resolve_tile=_hadv_resolve_tile,
    build_local_step=_hadv_local_step,
    build_shard_local=_hadv_shard_local,
    apply_stage=_hadv_apply_stage,
    pallas_calls=lambda variant, nf, k: {"unfused": 0,
                                         "whole_state": 1}[variant],
    model_tile=_hadv_model_tile,
    traffic=_plane_traffic("hadv_upwind"),
    exchange_model=_generic_exchange_model,
    cuda_tile_candidates=_hadv_cuda_tile_candidates,
    chainable=True,
))


# ---------------------------------------------------------------------------
# "asselin" — point-wise time filter (zero rides, no kernel)
# ---------------------------------------------------------------------------


def _asselin_local_step(plan):
    """Single-device asselin round, every variant: the point-wise filter
    in torch on the field-stacked state. The JAX package has no Pallas
    kernel for it either (XLA fuses the point-wise expression), so this is
    the op itself, not a stand-in for a kernel."""
    prog = plan.program
    names, coeff, dt = prog.fields, prog.coeff, prog.dt

    def step(state: WeatherState) -> WeatherState:
        stack = lambda d: _stack(d, names)
        fs = stack(state.fields)
        fs = fs + coeff * dt * (stack(state.tens) - stack(state.stage_tens))
        return _new_state(state, _dycore.unstack_state(fs, names),
                          dict(state.stage_tens))
    return step


def _asselin_shard_local(plan):
    """asselin's round on a mesh: point-wise on each shard, no ride."""
    prog = plan.program
    names, coeff, dt = prog.fields, prog.coeff, prog.dt

    def local(fields, wcon, tens, stage_tens):
        new_fields = []
        for fd, td, sd in zip(fields, tens, stage_tens):
            stack = lambda d: _stack(d, names)
            fs = stack(fd) + coeff * dt * (stack(td) - stack(sd))
            new_fields.append(field_views(fs, names))
        return new_fields, [dict(d) for d in stage_tens]
    return local


def _asselin_apply_stage(prog, names, use_ref):
    """asselin as a chain stage: the same point-wise filter on the slabs."""
    coeff, dt = prog.coeff, prog.dt

    def fn(fields, wconp, tens, stage_tens):
        return ({**fields, **{n: fields[n] + coeff * dt
                              * (tens[n] - stage_tens[n]) for n in names}},
                dict(stage_tens))
    return fn


register_stencil_op(StencilOpDef(
    name="asselin",
    title="leapfrog time filter from stored tendencies (point-wise)",
    reads=("fields", "tens", "stage_tens"),
    writes=("fields",),
    halo=0,
    flops_per_point=ASSELIN_FLOPS_PER_POINT,
    rides=(),
    variants=("unfused", "whole_state"),
    inkernel_kstep=False,
    pads_single_chip=False,
    packed_variants=("unfused", "whole_state"),
    tile_spaces=(),
    # no kernel, so no tile and no model window: report() models its
    # traffic at a window of the whole grid (`traffic_model_ty` = ny)
    resolve_tile=lambda variant, compute_grid, dtype, nf, e, k, request=None:
        None,
    build_local_step=_asselin_local_step,
    build_shard_local=_asselin_shard_local,
    apply_stage=_asselin_apply_stage,
    pallas_calls=lambda variant, nf, k: 0,
    model_tile=lambda variant, compute_grid, dtype, nf, e, k: None,
    traffic=_plane_traffic("asselin"),
    exchange_model=_generic_exchange_model,
    chainable=True,
))
