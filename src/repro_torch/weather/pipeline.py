"""Pipeline programs: a chain of registered stages compiled as one plan.

A port of `repro.weather.pipeline`.

* `PipelineProgram` is a `StencilProgram` whose op is an ordered list of
  registered stages (`PipelineStage`: an op name and an optional field
  binding). Constructing one synthesizes and registers the chain's
  `StencilOpDef` under its signature (`pipeline_op_name`), so
  `program.compile` plans it like any other op, with no pipeline branch.
* **The rides.** A backward validity analysis walks the stages in reverse,
  accumulating how far beyond the interior each operand must be valid
  before the chain runs (a stage's reach is its own declared k=1 ride; a
  written operand resets the requirement). The merged per-operand
  `(lo, hi)` depths become the chain op's `OperandRide`s. The analysis
  runs at k = 1 and 2 and the depths are encoded as `k*base + fixed`
  (checked linear at k = 3), so a chain whose footprint deepens has a
  k-step round.
* **The round** (`ChainRound`). On one device the round runs each stage's
  own solo plan, compiled once with the chain's variant over the stage's
  bound fields, in order (k times for a k-step round). So the chain is
  its solo sequence, bit for bit, and on CUDA it launches the stages'
  hand-written kernels (one a stage, none for `asselin`); the unfused
  chain runs their plain versions.
* **What runs.** Stage i's output goes through device memory before stage
  i+1 reads it, and each stage pads and crops as its solo step does (of
  the chainable ops only hdiff pads).
* **The mesh round** (`_pipeline_shard_local`, the JAX package's): ONE
  packed exchange per direction of every operand at its merged depth,
  each shard's operands edge-padded to the common slab, the stages in
  order on the resident slabs through their `apply_stage` lowerings (k
  times for a k-step round), and one crop. That is what buys one exchange
  a round across a mesh, whatever the chain's length; on one device it
  only adds padding (PERF.md §6), so one device keeps `ChainRound`.
* **The model.** `core/memmodel.pipeline_step_traffic` prices the chain
  as one pass whose intermediates stay on chip (`chained_per_round`)
  against the sum of the solo stages (`sequential_per_round`, nearer
  what runs); the chain's tile space is `core/tiling.pipeline_spec`,
  registered in `core/autotune` under the chain's name, and
  `report()["model"]` estimates its window. No launch takes the window:
  the chain's plan has no kernel tile (`resolve_tile` gives None), each
  stage's plan has its own.

Stage semantics: stages share the program's `coeff` and `dt` and may write
only `fields` and `stage_tens` (`wcon` and the slow tendencies are read
only). A binding (`fields=("u",)`) restricts a stage to some of the
program's fields; the others pass through it bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import autotune, memmodel, tiling
from repro_torch.weather import domain as _domain
from repro_torch.weather import dycore as _dycore
from repro_torch.weather import stencil_ops as _sops
from repro_torch.weather.fields import WeatherState, dtype_name, field_views
from repro_torch.weather.program import StencilProgram, compile
from repro_torch.weather.stencil_ops import (OperandRide, StencilOpDef,
                                             get_stencil_op,
                                             register_stencil_op)

__all__ = ["PipelineStage", "PipelineProgram", "pipeline_op_name",
           "ChainRound"]

# Operand slots a stage may write (wcon and the slow tendencies are read
# only).
_WRITABLE = ("fields", "stage_tens")
_PER_FIELD = ("fields", "tens", "stage_tens")
_ZERO = ((0, 0), (0, 0))


@dataclasses.dataclass(frozen=True)
class PipelineStage:
    """One chain link: a registered op plus an optional field binding.

    `fields=None` binds the stage to every program field; a tuple
    restricts it (unbound fields pass through that stage bit for bit)."""

    op: str
    fields: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.fields is not None:
            object.__setattr__(self, "fields", tuple(self.fields))

    def describe(self) -> Dict[str, Any]:
        return {"op": self.op,
                "fields": None if self.fields is None else list(self.fields)}


def pipeline_op_name(stages) -> str:
    """The chain's op name, its signature. Bindings are part of the name
    because the merged rides depend on them: two pipelines with the same
    signature share one registry entry."""
    sig = []
    for st in stages:
        s = st.op
        if st.fields is not None:
            s += "[" + ",".join(st.fields) + "]"
        sig.append(s)
    return "pipeline(" + "->".join(sig) + ")"


# ---------------------------------------------------------------------------
# Backward validity analysis -> merged OperandRides
# ---------------------------------------------------------------------------


def _req_add(a, b):
    return ((a[0][0] + b[0][0], a[0][1] + b[0][1]),
            (a[1][0] + b[1][0], a[1][1] + b[1][1]))


def _req_max(a, b):
    return ((max(a[0][0], b[0][0]), max(a[0][1], b[0][1])),
            (max(a[1][0], b[1][0]), max(a[1][1], b[1][1])))


def _chain_requirements(stages, field_names, k: int):
    """Walk `k` chain repetitions BACKWARD, accumulating per-(operand,
    field) validity requirements: how far beyond the interior each slot
    must be valid before the round runs so the final interior crop is
    exact. A stage's reads need (max requirement over its written slots)
    + the stage's own declared per-operand reach; writing a slot RESETS
    its requirement to what the stage itself reads it at."""
    req: Dict[Tuple[str, Optional[str]], Any] = {}

    def get(key):
        return req.get(key, _ZERO)

    for _ in range(k):
        for st in reversed(stages):
            od = get_stencil_op(st.op)
            bound = st.fields if st.fields is not None else field_names
            reach = {r.operand: r.depths(1) for r in od.rides}
            needed = _ZERO
            for w in od.writes:
                for f in bound:
                    needed = _req_max(needed, get((w, f)))
            new_read: Dict[Tuple[str, Optional[str]], Any] = {}
            for o in od.reads:
                cand = _req_add(needed, reach.get(o, _ZERO))
                if o in _PER_FIELD:
                    for f in bound:
                        new_read[(o, f)] = cand
                else:
                    new_read[(o, None)] = cand
            written = {(w, f) for w in od.writes for f in bound}
            for key, cand in new_read.items():
                if key not in written:
                    req[key] = _req_max(get(key), cand)
            for key in written:
                req[key] = new_read.get(key, _ZERO)
    merged: Dict[str, Any] = {}
    for (o, _f), r in req.items():
        merged[o] = _req_max(merged.get(o, _ZERO), r)
    return merged


def _chain_rides(stages, field_names):
    """Merged per-operand rides in `k*base + fixed` form, plus whether the
    footprint is LINEAR in k (the k-step precondition: the analysis at
    k=3 must match the extrapolation from k=1 and k=2) and whether it
    deepens with k."""
    r1 = _chain_requirements(stages, field_names, 1)
    r2 = _chain_requirements(stages, field_names, 2)
    r3 = _chain_requirements(stages, field_names, 3)
    operands = sorted(set(r1) | set(r2) | set(r3))
    rides, linear, deepens = [], True, False
    for o in operands:
        a = r1.get(o, _ZERO)
        b = r2.get(o, _ZERO)
        c = r3.get(o, _ZERO)
        base = ((b[0][0] - a[0][0], b[0][1] - a[0][1]),
                (b[1][0] - a[1][0], b[1][1] - a[1][1]))
        if (min(base[0] + base[1]) < 0
                or _req_add(b, base) != c):
            linear = False
        if any(d > 0 for d in base[0] + base[1]):
            deepens = True
        fixed = ((a[0][0] - base[0][0], a[0][1] - base[0][1]),
                 (a[1][0] - base[1][0], a[1][1] - base[1][1]))
        if not any(d > 0 for d in a[0] + a[1] + base[0] + base[1]):
            continue              # never rides: zero at every k
        rides.append(OperandRide(o, y=base[0], x=base[1],
                                 y_fixed=fixed[0], x_fixed=fixed[1],
                                 per_field=o in _PER_FIELD))
    return tuple(rides), linear, deepens


# ---------------------------------------------------------------------------
# The synthesized chain op: tile space, model, traffic, the round
# ---------------------------------------------------------------------------


def _stage_tile_spec(st: PipelineStage) -> tiling.OpSpec:
    """The tile space a stage models as: its op's whole-state space when
    it registers one, else the op's own registered spec."""
    od = get_stencil_op(st.op)
    name = dict(od.tile_spaces).get("whole_state", st.op)
    return autotune.get_op(name)


def _make_chain_spec(name, stages, field_names) -> tiling.OpSpec:
    reads = set()
    writes = set()
    for st in stages:
        od = get_stencil_op(st.op)
        reads.update(od.reads)
        writes.update(od.writes)
    nf = max(1, len(field_names))
    fields_in = (sum(1 for o in _PER_FIELD if o in reads)
                 + (1.0 / nf if "wcon" in reads else 0.0))
    fields_out = sum(1 for o in _PER_FIELD if o in writes)
    halo = sum(get_stencil_op(st.op).halo for st in stages)
    return tiling.pipeline_spec(
        name, [_stage_tile_spec(st) for st in stages],
        fields_in=fields_in, fields_out=fields_out, halo=(0, halo, halo))


def _pipeline_model_tile(spec: tiling.OpSpec):
    """The model's window of the chain (the JAX package's resolved tile):
    the tuner's pick in `spec`'s space at the compute grid, its rows
    snapped to a divisor. `report()["model"]` estimates it; no launch
    takes it."""
    def model(variant, compute_grid, dtype, n_fields, ensemble, k):
        if variant == "unfused":
            return None
        grid = tuple(int(g) for g in compute_grid)
        tz, ty, tx = autotune.tune(spec, grid, dtype).plan.tile
        ty = tiling.snap_to_divisor(ty, grid[1], lo=1)
        return tiling.TilePlan(op=spec, grid_shape=grid, tile=(tz, ty, tx),
                               dtype=dtype_name(dtype))
    return model


def _pipeline_traffic(spec: tiling.OpSpec, stages):
    def traffic(plan, model_ty):
        prog = plan.program
        nz, ny, nx = prog.grid_shape
        tile = (nz if 0 in spec.seq_axes else 1,
                tiling.snap_to_divisor(model_ty, ny, lo=1), nx)
        pairs = [(_stage_tile_spec(st),
                  len(st.fields) if st.fields is not None
                  else prog.n_fields) for st in stages]
        return memmodel.pipeline_step_traffic(
            spec, pairs, prog.grid_shape, prog.dtype, tile=tile,
            k_steps=plan.k_steps)
    return traffic


def _pipeline_pallas_calls(stages):
    """Kernel launches a round: k times the stages' whole-state launches
    (each at its bound field count); none for the unfused chain."""
    def calls(variant, nf, k):
        if variant == "unfused":
            return 0
        per_chain = sum(
            get_stencil_op(st.op).pallas_calls(
                "whole_state",
                len(st.fields) if st.fields is not None else nf, 1)
            for st in stages)
        return k * per_chain
    return calls


class ChainRound:
    """A chain plan's single-device round (see the module docstring), the
    plan's step function: each stage's own solo plan (the chain's variant,
    one step, over the stage's bound fields) in order, k times for a
    k-step round. A binding's stage gets the whole state: its solo step
    reads and writes only the bound fields, and the others pass through as
    the earlier stages left them."""

    def __init__(self, stages, plan):
        prog = plan.program
        variant = "unfused" if plan.variant == "unfused" else "whole_state"
        self.k = plan.k_steps
        self.plans = [compile(StencilProgram(
            grid_shape=prog.grid_shape, ensemble=prog.ensemble,
            fields=st.fields if st.fields is not None else prog.fields,
            dtype=prog.dtype, coeff=prog.coeff, dt=prog.dt, variant=variant,
            k_steps=1, op=st.op, hardware=prog.hardware),
            device=plan.device) for st in stages]

    def __call__(self, state: WeatherState) -> WeatherState:
        for _ in range(self.k):
            for plan in self.plans:
                out = plan.step(state)
                state = WeatherState(
                    fields={**state.fields, **out.fields}, wcon=state.wcon,
                    tens=state.tens,
                    stage_tens={**state.stage_tens, **out.stage_tens})
        return state


def _edge_pad(a: torch.Tensor, d_lo: int, d_hi: int, dim: int):
    """`a` extended along `dim` by copies of its first row (`d_lo` times)
    and its last (`d_hi`): finite values the validity analysis keeps away
    from the interior (zeros or a NaN could reach a stencil window that
    straddles the pad)."""
    if d_lo == 0 and d_hi == 0:
        return a
    n = a.shape[dim]
    lo = a.narrow(dim, 0, 1).expand(*[d_lo if i == dim % a.dim() else -1
                                      for i in range(a.dim())])
    hi = a.narrow(dim, n - 1, 1).expand(*[d_hi if i == dim % a.dim() else -1
                                          for i in range(a.dim())])
    return torch.cat([lo, a, hi], dim=dim)


def _pipeline_shard_local(stages):
    """The chain's round on a mesh: ONE packed exchange per direction at the
    merged ragged depths, every operand edge-padded to the common slab,
    the stages in order on each shard's resident slabs, one crop."""

    def build(plan):
        prog = plan.program
        names = prog.fields
        mesh = plan.mesh
        _, ax_y, ax_x = plan.mesh_axes
        k, wire = plan.k_steps, prog.exchange_dtype
        use_ref = plan.variant == "unfused"
        rides = {name: (dy, dx) for name, dy, dx in plan.rides}
        depth = lambda o: rides.get(o, _ZERO)
        reads, writes = set(), set()
        for st in stages:
            reads.update(get_stencil_op(st.op).reads)
            writes.update(get_stencil_op(st.op).writes)
        # per-field operands every stage sees on the slab, in canonical order
        slab_ops = tuple(o for o in _PER_FIELD if o in reads)
        wcon_read = "wcon" in reads
        # the common slab: per side the deepest per-field operand's depth
        t_lo_y = max([depth(o)[0][0] for o in slab_ops] or [0])
        t_hi_y = max([depth(o)[0][1] for o in slab_ops] or [0])
        t_lo_x = max([depth(o)[1][0] for o in slab_ops] or [0])
        t_hi_x = max([depth(o)[1][1] for o in slab_ops] or [0])
        stage_fns = [get_stencil_op(st.op).apply_stage(
            prog, st.fields if st.fields is not None else names, use_ref)
            for st in stages]

        def pad_to(a, have, want_lo, want_hi, dim):
            return _edge_pad(a, want_lo - have[0], want_hi - have[1], dim)

        def local(fields, wcon, tens, stage_tens):
            ly, lx = wcon[0].shape[-2:]
            src = {"fields": fields, "tens": tens, "stage_tens": stage_tens}
            ops = slab_ops + (("wcon",) if wcon_read else ())
            shards = {o: [_dycore.stack_state(d, names) for d in src[o]]
                      for o in slab_ops}
            if wcon_read:
                shards["wcon"] = list(wcon)
            # ONE packed ride pair per direction for the whole chain
            parts = _domain._exchange_packed(
                [(shards[o], depth(o)[0]) for o in ops], mesh, ax_y, dim=-2,
                wire_dtype=wire)
            parts = _domain._exchange_packed(
                [(p, depth(o)[1]) for p, o in zip(parts, ops)], mesh, ax_x,
                dim=-1, wire_dtype=wire)
            slabs = dict(zip(ops, parts))
            new_fields, new_stage = [], []
            for s in range(mesh.size):
                views = {}
                for o in slab_ops:
                    dy, dx = depth(o)
                    a = pad_to(slabs[o][s], dy, t_lo_y, t_hi_y, dim=-2)
                    a = pad_to(a, dx, t_lo_x, t_hi_x, dim=-1)
                    views[o] = field_views(a, names)
                if wcon_read:
                    # one column wider on the high-x side: the staggering
                    dy, dx = depth("wcon")
                    wconp = pad_to(slabs["wcon"][s], dy, t_lo_y, t_hi_y, -2)
                    wconp = pad_to(wconp, dx, t_lo_x, t_hi_x + 1, -1)
                else:
                    wconp = wcon[s]
                fd = views.get("fields", dict(fields[s]))
                td = views.get("tens", dict(tens[s]))
                sd = views.get("stage_tens", dict(stage_tens[s]))
                # the chain on the resident slabs, k repetitions on one deep
                # exchange (validity shrinks as the rides account for)
                for _ in range(k):
                    for fn in stage_fns:
                        fd, sd = fn(fd, wconp, td, sd)
                crop = lambda d: field_views(torch.stack(
                    [d[n][..., t_lo_y:t_lo_y + ly, t_lo_x:t_lo_x + lx]
                     for n in names], dim=1), names)
                new_fields.append(crop(fd) if "fields" in writes
                                  else dict(fields[s]))
                new_stage.append(crop(sd) if "stage_tens" in writes
                                 else dict(stage_tens[s]))
            return new_fields, new_stage
        return local
    return build


def _ensure_registered(name: str, stages: Tuple[PipelineStage, ...],
                       field_names: Tuple[str, ...]) -> StencilOpDef:
    """Synthesize and register the chain's StencilOpDef and tile space
    (idempotent: the name encodes the signature AND bindings, so a second
    program with the same chain reuses the entry)."""
    if name in _sops.STENCIL_OPS:
        return get_stencil_op(name)
    rides, linear, deepens = _chain_rides(stages, field_names)
    halo = sum(get_stencil_op(st.op).halo for st in stages)
    variants = ("unfused", "whole_state")
    if linear and deepens and halo > 0:
        variants = variants + ("kstep",)
    spec = _make_chain_spec(name, stages, field_names)
    autotune.register_op(spec)
    flops = sum(
        get_stencil_op(st.op).flops_per_point for st in stages)
    reads, writes = [], []
    for o in ("fields", "wcon", "tens", "stage_tens"):
        if any(o in get_stencil_op(st.op).reads for st in stages):
            reads.append(o)
        if any(o in get_stencil_op(st.op).writes for st in stages):
            writes.append(o)
    return register_stencil_op(StencilOpDef(
        name=name,
        title="stage chain: " + " -> ".join(st.op for st in stages),
        reads=tuple(reads),
        writes=tuple(writes),
        halo=halo,
        flops_per_point=flops,
        rides=rides,
        variants=variants,
        inkernel_kstep=False,
        pads_single_chip=True,
        packed_variants=variants,
        tile_spaces=tuple((v, name) for v in variants if v != "unfused"),
        # no kernel tile: each stage's own plan has one
        resolve_tile=lambda variant, compute_grid, dtype, nf, e, k,
        request=None: None,
        build_local_step=lambda plan: ChainRound(stages, plan),
        build_shard_local=_pipeline_shard_local(stages),
        pallas_calls=_pipeline_pallas_calls(stages),
        model_tile=_pipeline_model_tile(spec),
        traffic=_pipeline_traffic(spec, stages),
        exchange_model=_sops._generic_exchange_model,
        # a k-step round repeats the one-step stages k times
        kstep_check=lambda program, shards: (lambda k: None),
    ))


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineProgram(StencilProgram):
    """A `StencilProgram` whose op is an ordered stage chain.

    Construction synthesizes and registers the chain's `StencilOpDef`
    (merged rides, the single-device round, the chained traffic model)
    under the signature name, then validates like any program:
    `program.compile` needs no pipeline awareness. `op` is derived; do
    not set it."""

    stages: Tuple[PipelineStage, ...] = ()

    def __post_init__(self):
        stages = []
        for st in self.stages:
            if isinstance(st, PipelineStage):
                stages.append(st)
            elif isinstance(st, str):
                stages.append(PipelineStage(op=st))
            elif isinstance(st, dict):
                f = st.get("fields")
                stages.append(PipelineStage(
                    op=st["op"], fields=None if f is None else tuple(f)))
            else:
                raise TypeError(f"stage {st!r}: expected a PipelineStage, "
                                f"op name, or {{'op': ...}} dict")
        stages = tuple(stages)
        object.__setattr__(self, "stages", stages)
        if not stages:
            raise ValueError("a PipelineProgram needs at least one stage")
        names = tuple(self.fields)
        for st in stages:
            od = get_stencil_op(st.op)      # raises on unknown ops
            if not od.chainable:
                # the JAX package's message (its stages lower by
                # apply_stage)
                raise ValueError(
                    f"op {st.op!r} cannot ride in a pipeline (no "
                    f"apply_stage lowering)")
            bad = set(od.writes) - set(_WRITABLE)
            if bad:
                raise ValueError(
                    f"stage {st.op!r} writes {sorted(bad)}: a pipeline "
                    f"round may only write {list(_WRITABLE)}")
            if st.fields is not None:
                missing = [f for f in st.fields if f not in names]
                if missing:
                    raise ValueError(
                        f"stage {st.op!r} binds unknown fields {missing} "
                        f"(program fields: {list(names)})")
                if not st.fields:
                    raise ValueError(f"stage {st.op!r}: an explicit "
                                     f"binding needs at least one field")
        name = pipeline_op_name(stages)
        if self.op not in ("dycore", name):
            raise ValueError(f"op={self.op!r}: a PipelineProgram derives "
                             f"its op from the stages ({name!r}); leave "
                             f"it unset")
        object.__setattr__(self, "op", name)
        opdef = _ensure_registered(name, stages, names)
        if self.halo is not None and self.halo != opdef.halo:
            raise ValueError(f"halo={self.halo}: chain {name!r} reaches "
                             f"{opdef.halo} per step")
        super().__post_init__()

    def to_json(self) -> Dict[str, Any]:
        d = super().to_json()
        d["stages"] = [st.describe() for st in self.stages]
        return d
