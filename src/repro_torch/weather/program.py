"""Declarative stencil programs: spec -> plan -> launch, on one device or
a mesh.

A port of `repro.weather.program`:

* `StencilProgram` is the *what*: the registered op (`"dycore"`, `"hdiff"`,
  `"vadvc"`, `"vadvc_update"`, `"hadv_upwind"`, `"asselin"`, or a stage
  chain's `"pipeline(...)"`), grid, ensemble, field set, precision, step
  policy and the hardware spec its modelled numbers target. It keeps the
  JAX package's checks, and `to_json` / `from_json` round-trip with the JAX
  package's JSON; a program with `stages` comes back as a
  `weather/pipeline.py::PipelineProgram`.
* `compile(program, mesh=None, device="cuda", tune=None)` is the planner:
  it resolves the execution variant, the kernel tile and the launch count
  per round once, and on a mesh the steps-per-round k (`k_steps="auto"`:
  the exchange model's pick, walked down to what the CUDA k-step kernel
  takes), the packed-exchange schedule (`ExchangeSchedule`, from the op's
  declared rides) and the rides a round. The tile is the kernel's own
  rule (`core/tiling.py`); with `tune="measure"` it is the candidate tile
  (the op's `cuda_tile_candidates`) that ran the round fastest on the
  plan's device or mesh, measured once and kept in a disk cache
  (`core/autotune.py`).
* `ExecutionPlan` is the *how*: `step(state)` advances one round of
  `k_steps` timesteps, `run(state, steps)` runs `steps // k_steps` rounds and
  one shorter tail round (`round_plan(steps % k_steps)`), `report()` returns
  the strategy under the JAX package's key names: the structure, the
  modelled bytes of a step (`traffic`), the analytic model of the variant's
  window under the program's hardware spec (`model`) and the paper's
  cross-machine table (`model_by_hardware`).

What runs is decided by the plan's device: on CUDA every kernelled variant
launches the hand-written kernels (a k-step round is ONE launch of the
k-step kernel; a chain's round one launch a stage); on the CPU the same
lowering takes their plain versions.

A mesh (`launch/mesh.py::Mesh`, a grid of devices driven from this one
process) shards y over `ax_y`, x over `ax_x` and the ensemble over `ax_e`
when the mesh has it; z is never split. A mesh plan's `step` / `run` take
a state placed by `domain.shard_state(state, plan.mesh, plan.state_spec)`
and return one (a plain `WeatherState` is placed first);
`domain.gather_state` brings it back whole. Its round is the op's
shard-local round (`StencilOpDef.build_shard_local`) over every shard: the
packed halo exchange of `weather/domain.py`, each shard's launches on its
padded slab, the crop. `report()["pallas_calls_per_round"]` counts one
shard's launches, as the JAX package's traced shard program does; a round
launches that many on every shard. `compile_with_fallback` degrades an
op that fails to compile to its `reference_program`, and says so; on the
card it does so only for an injected fault.

The serving engine's slot helpers sit here too, as in the JAX package:
`ensemble_slot_view` / `_assign` / `_select` (in place, keeping a lane's
field-stacked layout) and `slot_guard` / `slot_validity` (one launch of the
slot-guard kernel on CUDA), each also on a `domain.ShardedState` (shard by
shard in place; the guard a partial launch a distinct block and one
combine, the whole state's digest).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import autotune, hwspec, memmodel, perfmodel, tiling
from repro_torch.core.spans import LOWERING, span, spanned
from repro_torch.kernels.slot_guard import ops as _guard_ops
from repro_torch.launch.mesh import Mesh
from repro_torch.weather import domain as _domain
from repro_torch.weather import dycore as _dycore
from repro_torch.weather import stencil_ops as _sops
from repro_torch.weather.fields import (PROGNOSTIC, WeatherState, dtype_name,
                                        field_views, state_leaves,
                                        zeros_state)
from repro_torch.weather.stencil_ops import (StencilOpDef, get_stencil_op,
                                             register_stencil_op,
                                             registered_stencil_ops)

VARIANTS = _sops.VARIANTS
# The hardware specs the port ships (`repro_torch/specs/*.json`): a
# program's `hardware` names the one its modelled numbers target.
KNOWN_HARDWARE = hwspec.available_specs()

__all__ = ["StencilProgram", "DycoreProgram", "ExchangeSchedule",
           "ExecutionPlan", "compile", "compile_dycore", "plan_cache_key",
           "compile_with_fallback", "reference_program", "StencilOpDef",
           "get_stencil_op", "register_stencil_op",
           "registered_stencil_ops", "VARIANTS", "ensemble_slot_view",
           "ensemble_slot_assign", "ensemble_slot_select", "slot_validity",
           "slot_guard", "state_leaves", "map_state"]


@dataclasses.dataclass(frozen=True)
class StencilProgram:
    """The *what* of a stencil run: op + field set + grid + policies (the
    JAX package's fields, defaults and checks)."""

    grid_shape: Tuple[int, int, int]            # (nz, ny, nx)
    ensemble: int = 1
    fields: Tuple[str, ...] = PROGNOSTIC
    halo: Optional[int] = None                  # op's reach; checked if given
    dtype: str = "float32"
    boundary: str = "periodic"
    coeff: float = 0.025
    dt: float = 0.1
    variant: str = "auto"
    k_steps: Any = "auto"                       # int or "auto"
    exchange_dtype: Optional[str] = None
    op: str = "dycore"
    hardware: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "grid_shape",
                           tuple(int(g) for g in self.grid_shape))
        object.__setattr__(self, "fields", tuple(self.fields))
        object.__setattr__(self, "dtype", dtype_name(self.dtype))
        if self.exchange_dtype is not None:
            object.__setattr__(self, "exchange_dtype",
                               dtype_name(self.exchange_dtype))
        try:
            opdef = get_stencil_op(self.op)
        except KeyError as e:
            raise ValueError(str(e)) from None
        if self.halo is None:
            object.__setattr__(self, "halo", opdef.halo)
        if len(self.grid_shape) != 3 or min(self.grid_shape) < 1:
            raise ValueError(f"grid_shape={self.grid_shape} must be a "
                             f"positive (nz, ny, nx) triple")
        if not self.fields:
            raise ValueError("a StencilProgram needs at least one field")
        if self.ensemble < 1:
            raise ValueError(f"ensemble={self.ensemble} must be >= 1")
        if self.boundary != "periodic":
            raise ValueError(f"boundary={self.boundary!r}: only 'periodic' "
                             f"is implemented")
        if self.halo != opdef.halo:
            raise ValueError(f"halo={self.halo}: op {self.op!r} declares a "
                             f"fixed stencil reach of {opdef.halo}")
        if self.variant != "auto" and self.variant not in opdef.variants:
            raise ValueError(f"variant={self.variant!r} not supported by "
                             f"op {self.op!r} (supported: "
                             f"{('auto',) + opdef.variants})")
        if self.k_steps != "auto" and (not isinstance(self.k_steps, int)
                                       or self.k_steps < 1):
            raise ValueError(f"k_steps={self.k_steps!r} must be a positive "
                             f"int or 'auto'")
        if (isinstance(self.k_steps, int) and self.k_steps > 1
                and "kstep" not in opdef.variants):
            raise ValueError(f"k_steps={self.k_steps}: op {self.op!r} has "
                             f"no k-step round (its footprint does not "
                             f"deepen with k)")
        if (self.variant in ("unfused", "per_field", "whole_state")
                and self.k_steps not in ("auto", 1)):
            raise ValueError(f"variant={self.variant!r} with "
                             f"k_steps={self.k_steps}: k_steps > 1 is the "
                             f"k-step strategy — use variant='kstep'")
        if self.variant == "kstep" and self.k_steps == 1:
            raise ValueError("variant='kstep' needs k_steps >= 2 (or "
                             "'auto'); k_steps=1 IS the whole-state step")
        if self.hardware is not None and self.hardware not in KNOWN_HARDWARE:
            raise ValueError(f"unknown hardware spec {self.hardware!r}; "
                             f"known: {list(KNOWN_HARDWARE)}")

    @property
    def n_fields(self) -> int:
        return len(self.fields)

    def to_json(self) -> Dict[str, Any]:
        """Plain-JSON spec; round-trips through `from_json`, in either
        package."""
        d = dataclasses.asdict(self)
        d["grid_shape"] = list(self.grid_shape)
        d["fields"] = list(self.fields)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "StencilProgram":
        d = dict(d)
        if "stages" in d and cls is StencilProgram:
            # a serialized PipelineProgram (late import: pipeline.py builds
            # on this module)
            from repro_torch.weather.pipeline import PipelineProgram
            return PipelineProgram.from_json(d)
        d["grid_shape"] = tuple(d["grid_shape"])
        d["fields"] = tuple(d["fields"])
        return cls(**d)


# The dycore spec is an alias: `op` already defaults to "dycore".
DycoreProgram = StencilProgram


def plan_cache_key(program: StencilProgram,
                   ensemble: Optional[int] = None) -> StencilProgram:
    """The compile-once cache key of `program`: the frozen, normalized
    program itself, with `ensemble` rebound when given (requests that
    differ only in ensemble share a plan keyed at the slot count)."""
    if ensemble is not None and ensemble != program.ensemble:
        program = dataclasses.replace(program, ensemble=ensemble)
    return program


# --- ensemble-slot views: requests <-> the (e, ...) batch axis -------------
# Every WeatherState leaf is (E, nz, ny, nx); a serving slot is one member.
# A lane keeps the field-stacked layout (each dict's leaves the planes of one
# tensor, `fields.field_views`), so the whole-state kernel takes it without a
# copy: the helpers below write in place, by index, into the lane's storage.


def map_state(state: WeatherState, fn) -> WeatherState:
    """`fn` applied to each of the state's tensors, keeping its layout: a
    field-stacked dict goes through `fn` as its one stacked tensor and comes
    back as views of the result, any other dict leaf by leaf."""
    def group(d):
        names = tuple(d)
        base = _dycore._stacked_base([d[n] for n in names])
        if base is None:
            return {n: fn(t) for n, t in d.items()}
        return field_views(fn(base), names)
    return WeatherState(fields=group(state.fields), wcon=fn(state.wcon),
                        tens=group(state.tens),
                        stage_tens=group(state.stage_tens))


def _tensor_pairs(a: WeatherState, b: WeatherState):
    """[(a's tensor, b's tensor), ...] covering every leaf once: a dict's
    stacked tensors when both states stack it (in the same order), else its
    leaves pairwise."""
    pairs = [(a.wcon, b.wcon)]
    for part in ("fields", "tens", "stage_tens"):
        da, db = getattr(a, part), getattr(b, part)
        names = tuple(da)
        ba = _dycore._stacked_base([da[n] for n in names])
        bb = _dycore._stacked_base([db[n] for n in names])
        if ba is not None and bb is not None:
            pairs.append((ba, bb))
        else:
            pairs += [(da[n], db[n]) for n in names]
    return pairs


def ensemble_slot_view(state, e: int) -> WeatherState:
    """Member `e` of a batched state as an ensemble-1 state of views; of a
    `domain.ShardedState`, that slot gathered to the CPU (only its blocks
    are read, each from one shard)."""
    if isinstance(state, _domain.ShardedState):
        return _domain.gather_state(state, slot=e)
    return map_state(state, lambda a: a[e:e + 1])


def ensemble_slot_assign(batch, indices, sub: WeatherState):
    """Write `sub` (leading dim = len(indices)) into the given ensemble
    slots of `batch`, in place (the JAX package returns a new batch);
    returns `batch`. On a `domain.ShardedState` each shard holding one of
    the slots takes its block of `sub` into its own slot."""
    indices = [int(i) for i in indices]
    if isinstance(batch, _domain.ShardedState):
        for (e0, y0, x0), sh in zip(_domain.block_offsets(batch),
                                    batch.shards):
            held = int(sh.wcon.shape[0])
            pick = [(j, e - e0) for j, e in enumerate(indices)
                    if 0 <= e - e0 < held]
            if not pick:
                continue
            ly, lx = sh.wcon.shape[-2:]
            rows = [j for j, _ in pick]
            local = torch.as_tensor([loc for _, loc in pick],
                                    device=sh.wcon.device)
            for dst, src in zip(state_leaves(sh), state_leaves(sub)):
                block = src[..., y0:y0 + ly, x0:x0 + lx].index_select(
                    0, torch.as_tensor(rows, device=src.device))
                dst.index_copy_(0, local, block.to(dst.device, dst.dtype))
        return batch
    idx = torch.as_tensor(indices, dtype=torch.long, device=batch.device)
    for dst, src in _tensor_pairs(batch, sub):
        dst.index_copy_(0, idx, src.to(dst.device, dst.dtype))
    return batch


def ensemble_slot_select(mask, new, old):
    """Per-slot select, in place into `new`: slots where `mask` (shape
    (E,)) is True keep `new`, the rest take `old` (the JAX package returns
    a new state) — how a serving engine rolls back slots that sat out a
    shorter-than-their-next-part round. Tensors the two states share (the
    round did not write them) are left alone. Two `domain.ShardedState`s
    on one placement are selected shard by shard, each on its own slots.
    Returns `new`."""
    mask = [bool(m) for m in torch.as_tensor(mask).tolist()]
    if isinstance(new, _domain.ShardedState):
        for (e0, _, _), n, o in zip(_domain.block_offsets(new), new.shards,
                                    old.shards):
            ensemble_slot_select(mask[e0:e0 + int(n.wcon.shape[0])], n, o)
        return new
    keep = [i for i, m in enumerate(mask) if not m]
    if not keep:
        return new
    idx = torch.as_tensor(keep, dtype=torch.long, device=new.device)
    for n, o in _tensor_pairs(new, old):
        if n.data_ptr() == o.data_ptr() and n.stride() == o.stride():
            continue
        n.index_copy_(0, idx, o.index_select(0, idx))
    return new


def slot_guard(state, limit) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot validity and content fingerprint in one pass over the
    state's leaves (in the JAX package's order): `(ok, fp)`, ok an (E,)
    bool — every element finite and `|x| <= limit` — and fp an (E,) int64
    holding the JAX package's uint32 digest of the slot's exact bits. On
    CUDA one launch of the slot-guard kernel (`kernels/slot_guard`), on
    the CPU its plain version; both give the JAX package's values. On a
    `domain.ShardedState` the digest is the whole state's: one partial pass
    over each distinct block at its global offset, then one combine (on
    CUDA: a launch a block and one more)."""
    if isinstance(state, _domain.ShardedState):
        offsets = _domain.block_offsets(state)
        blocks = [(state_leaves(state.shards[s]),) + offsets[s]
                  for s in _domain.distinct_shards(state)]
        return _guard_ops.slot_guard_blocks(blocks, state.ensemble, limit)
    return _guard_ops.slot_guard(state_leaves(state), limit)


def slot_validity(state, limit) -> torch.Tensor:
    """Per-slot physics validity: `slot_guard`'s (E,) bool."""
    return slot_guard(state, limit)[0]


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether `a` and `b` name one device (`cuda` matches `cuda:0`)."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


@dataclasses.dataclass(frozen=True)
class ExchangeSchedule:
    """The resolved halo exchange of a mesh plan (the JAX package's).

    `mode="packed"` is the stacked ragged exchange: every operand shares
    one flattened wire buffer per direction (at most one ride pair each; a
    side nothing rides is elided). `rides` are the resolved per-operand
    `(lo, hi)` depths from the op's declaration, e.g. the dycore's `wcon`
    at `(k·2, k·2 + 1)` in x (the staggering column from the right
    neighbour only) or vadvc's lone `("wcon", (0, 0), (0, 1))`.
    `mode="per_operand"` is the per-field exchange of the dycore's
    per_field and unfused variants."""

    mode: str                                   # "packed" | "per_operand"
    shards: Tuple[int, int]                     # (py, px)
    rides: Tuple[Tuple[str, Tuple[int, int], Tuple[int, int]], ...]
    wire_dtype: Optional[str]

    def _ride(self, operand: str):
        for name, dy, dx in self.rides:
            if name == operand:
                return dy, dx
        return None

    @property
    def depth_y(self) -> int:
        r = self._ride("fields")
        return r[0][1] if r else 0

    @property
    def depth_x(self) -> int:
        r = self._ride("fields")
        return r[1][0] if r else 0

    @property
    def wcon_depth_x(self) -> Optional[Tuple[int, int]]:
        r = self._ride("wcon")
        return r[1] if r else None

    def describe(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "mode": self.mode, "shards": list(self.shards),
            "rides": {name: {"depth_y": list(dy), "depth_x": list(dx)}
                      for name, dy, dx in self.rides},
            "depth_y": self.depth_y, "depth_x": self.depth_x,
            "wire_dtype": self.wire_dtype}
        if self.wcon_depth_x is not None:
            d["wcon_depth_x"] = list(self.wcon_depth_x)
        return d


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The *how*: an immutable, fully resolved strategy on one device or a
    mesh (`mesh`; `device` is then the mesh's first device)."""

    program: StencilProgram
    variant: str                                # resolved, never "auto"
    k_steps: int                                # resolved timesteps a round
    tile_ty: Optional[int]                      # None for unfused
    tile: Optional[tiling.CudaTile]             # None for unfused
    local_grid: Tuple[int, int, int]
    compute_grid: Tuple[int, int, int]          # grid the kernel tiles over
    device: torch.device
    pallas_calls_per_round: int                 # kernel launches per round
    collectives_per_round: int                  # exchange rides per round
    rides: Tuple[Tuple[str, Tuple[int, int], Tuple[int, int]], ...] = ()
    exchange: Optional[ExchangeSchedule] = None  # None on one device
    mesh: Optional[Mesh] = dataclasses.field(default=None, repr=False,
                                             compare=False)
    mesh_axes: Tuple[Optional[str], str, str] = ("pod", "data", "model")
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def distributed(self) -> bool:
        return self.mesh is not None

    @property
    def shards(self) -> Tuple[int, int]:
        return self.exchange.shards if self.exchange is not None else (1, 1)

    @property
    def state_spec(self) -> Optional[Tuple[Optional[str], ...]]:
        """The placement `domain.shard_state` takes, the JAX package's
        `P(ax_e, None, ax_y, ax_x)` (ax_e None where the mesh lacks it);
        None on one device."""
        if self.mesh is None:
            return None
        ax_e, ax_y, ax_x = self.mesh_axes
        have_e = ax_e is not None and ax_e in self.mesh.axis_names
        return (ax_e if have_e else None, None, ax_y, ax_x)

    @property
    def op_def(self) -> StencilOpDef:
        return get_stencil_op(self.program.op)

    @property
    def hardware(self) -> str:
        """The spec the plan's modelled numbers target (never None)."""
        return self.program.hardware or hwspec.default_spec_name()

    def hardware_spec(self) -> hwspec.HardwareSpec:
        return hwspec.load_spec(self.hardware)

    def model_window(self) -> Optional[tiling.TilePlan]:
        """The analytic model's window of the plan's variant (the op's
        `model_tile`, tuned under `hwspec.default_spec()`), or None for the
        unfused oracle; cached. `report()["model"]` estimates it; no launch
        takes it."""
        if "model_window" not in self._cache:
            prog = self.program
            self._cache["model_window"] = self.op_def.model_tile(
                self.variant, self.compute_grid, prog.dtype, prog.n_fields,
                prog.ensemble, self.k_steps)
        return self._cache["model_window"]

    def step(self, state):
        """Advance ONE round (`k_steps` timesteps). On a mesh the state is a
        `domain.ShardedState` (a `WeatherState` is placed first) and so is
        the result."""
        with span("nero.plan.round"):
            LOWERING["rounds"] += 1
            LOWERING["steps"] += self.k_steps
            state = self._check_state(state)
            return self._step_fn()(state)

    @spanned("nero.plan.run")
    def run(self, state: WeatherState, steps: int) -> WeatherState:
        """Advance `steps` timesteps: `steps // k_steps` full rounds plus,
        when `steps % k_steps != 0`, one shorter tail round through
        `round_plan(steps % k_steps)`."""
        if not isinstance(steps, int) or steps < 0:
            raise ValueError(f"steps={steps!r} must be a non-negative int")
        state = self._check_state(state)
        rounds, tail = divmod(steps, self.k_steps)
        step = self._step_fn()
        for _ in range(rounds):
            with span("nero.plan.round"):
                LOWERING["rounds"] += 1
                LOWERING["steps"] += self.k_steps
                state = step(state)
        if tail:
            state = self.round_plan(tail).step(state)
        return state

    def round_plan(self, k: int) -> "ExecutionPlan":
        """The plan that advances a round of exactly `k` timesteps: `self`
        when `k == k_steps`, else a derived plan for the shorter round,
        compiled on the same device and cached (`run()`'s tail)."""
        if not isinstance(k, int) or not 1 <= k <= self.k_steps:
            raise ValueError(f"round_plan(k={k!r}): k must be an int in "
                             f"[1, k_steps={self.k_steps}]")
        if k == self.k_steps:
            return self
        plan = self._cache.get(("tail", k))
        if plan is None:
            ax_e, ax_y, ax_x = self.mesh_axes
            plan = compile(dataclasses.replace(self.program, variant="auto",
                                               k_steps=k), mesh=self.mesh,
                           ax_e=ax_e, ax_y=ax_y, ax_x=ax_x,
                           device=self.device)
            self._cache[("tail", k)] = plan
        return plan

    def report(self) -> Dict[str, Any]:
        """The strategy under the JAX package's key names, plain JSON: the
        structure, `traffic_model_ty` and `traffic` (the op's modelled
        bytes of a step at the rows of the kernel tile that runs; a plan
        with no tile takes `_traffic_model_ty`'s rows), `exchange_model`
        (the modelled wire bytes of a packed mesh round, None otherwise),
        `model` (the analytic model
        of `model_window()` under `hardware_spec()`, None for the unfused
        oracle), `model_by_hardware`, and `tuning`: the measured pick of
        `compile(tune="measure")`, None otherwise."""
        prog = self.program
        opdef = self.op_def
        rep = {
            "op": prog.op,
            "program": prog.to_json(),
            "variant": self.variant,
            "k_steps": self.k_steps,
            "footprint": self.op_def.describe(prog.n_fields, self.k_steps),
            "tile": (None if self.tile is None
                     else {"ty": self.tile_ty, **self.tile.describe()}),
            "device": str(self.device),
            "distributed": self.distributed,
            "mesh_axes": list(self.mesh_axes),
            "local_grid": list(self.local_grid),
            "compute_grid": list(self.compute_grid),
            "exchange": (None if self.exchange is None
                         else self.exchange.describe()),
            "pallas_calls_per_round": self.pallas_calls_per_round,
            "collectives_per_round": self.collectives_per_round,
        }
        model_ty = self.tile_ty
        if model_ty is None:
            model_ty = self._cache.get("traffic_model_ty")
            if model_ty is None:
                model_ty = self._traffic_model_ty()
                self._cache["traffic_model_ty"] = model_ty
        rep["traffic_model_ty"] = model_ty
        rep["traffic"] = opdef.traffic(self, model_ty)
        rep["exchange_model"] = None
        if (self.exchange is not None and self.exchange.mode == "packed"
                and opdef.exchange_model is not None):
            rep["exchange_model"] = opdef.exchange_model(
                prog, self.k_steps, self.exchange.shards)
        window = self.model_window()
        if window is None:
            rep["model"] = None
        else:
            est = self._cache.get("perf_est")
            if est is None:
                est = perfmodel.estimate(window, spec=self.hardware_spec())
                self._cache["perf_est"] = est
            rep["model"] = {"time_us": est.time_s * 1e6,
                            "gflops": est.gflops,
                            "gflops_per_watt": est.gflops_per_watt,
                            "bottleneck": est.bottleneck,
                            "hardware": est.hardware,
                            "kernel_class": est.kernel_class,
                            "spec_fingerprint":
                                self.hardware_spec().fingerprint}
        rep["model_by_hardware"] = self.model_by_hardware()
        rep["tuning"] = self._cache.get("tuning")
        return rep

    def _traffic_model_ty(self) -> int:
        """The rows the traffic model takes for a plan with no kernel tile:
        those of the tile a whole-state plan of the program launches; for
        a stage chain (whose stages each plan their own tile) the rows of
        its model window, as the JAX package's chain resolves its tile,
        at the compute grid, or for the unfused chain at the physical
        grid, as the JAX package's report resolves an oracle's; for an op
        with neither (asselin: no kernel, no window) the whole grid's ny,
        where the JAX package's report raises."""
        prog, opdef = self.program, self.op_def
        tile = opdef.resolve_tile("whole_state", self.compute_grid,
                                  prog.dtype, prog.n_fields, prog.ensemble,
                                  1)
        if tile is not None:
            return tile.ty
        window = self.model_window() or opdef.model_tile(
            "whole_state", prog.grid_shape, prog.dtype, prog.n_fields,
            prog.ensemble, 1)
        return prog.grid_shape[1] if window is None else window.tile[1]

    def model_by_hardware(self, grid_shape: Optional[Tuple[int, int, int]]
                          = None) -> Dict[str, Any]:
        """The paper's cross-machine two-kernel table, modelled: for hdiff
        and vadvc and every shipped hardware spec, re-tune the window for
        that machine's hierarchy and model time / GFLOPS / GFLOPS per watt
        under its spec, with the speedup over the POWER9 baseline. The JAX
        package's table, plus the `h100_sxm` row. `grid_shape` defaults to
        the program's grid; cached per grid. A kernel with no legal tile
        at the grid on some spec has no row, as in the JAX package."""
        grid = tuple(int(g) for g in (grid_shape or self.program.grid_shape))
        cached = self._cache.get(("model_by_hardware", grid))
        if cached is not None:
            return cached
        spec_names = hwspec.available_specs()
        out: Dict[str, Any] = {
            "grid_shape": list(grid),
            "dtype": self.program.dtype,
            "baseline": "power9",
            "specs": {n: hwspec.load_spec(n).describe() for n in spec_names},
            "kernels": {},
        }
        for kname in ("hdiff", "vadvc"):
            try:
                ests = perfmodel.estimate_by_hardware(
                    autotune.get_op(kname), grid, self.program.dtype,
                    specs=spec_names)
            except ValueError:
                continue
            t_p9 = ests["power9"].time_s if "power9" in ests else 0.0
            out["kernels"][kname] = {
                name: {"time_us": est.time_s * 1e6,
                       "gflops": est.gflops,
                       "gflops_per_watt": est.gflops_per_watt,
                       "bottleneck": est.bottleneck,
                       "kernel_class": est.kernel_class,
                       "speedup_vs_power9": (t_p9 / est.time_s
                                             if est.time_s > 0 else 0.0)}
                for name, est in ests.items()}
        self._cache[("model_by_hardware", grid)] = out
        return out

    def _check_state(self, state):
        """`state` checked against the program (and, on a mesh, placed on
        the plan's mesh); returns what the round takes."""
        if self.mesh is not None:
            return self._check_sharded(state)
        if isinstance(state, _domain.ShardedState):
            raise ValueError("a sharded state needs a plan compiled with "
                             "mesh=; gather it first (domain.gather_state)")
        self._check_leaves(state)
        if not same_device(state.device, self.device):
            raise ValueError(f"state is on {state.device} but the plan was "
                             f"compiled for {self.device}")
        return state

    def _check_sharded(self, state):
        if isinstance(state, _domain.ShardedState):
            if (state.grid_shape != self.program.grid_shape
                    or state.ensemble != self.program.ensemble):
                raise ValueError(
                    f"sharded state of grid {state.grid_shape} and ensemble "
                    f"{state.ensemble} does not match the program's "
                    f"{self.program.grid_shape} and {self.program.ensemble}")
            self._check_leaves(state.shards[0], whole=False)
        else:
            self._check_leaves(state)
        return _domain.shard_state(state, self.mesh, self.state_spec)

    def _check_leaves(self, state: WeatherState, whole: bool = True) -> None:
        if whole and state.grid_shape != self.program.grid_shape:
            raise ValueError(
                f"state grid {state.grid_shape} does not match the "
                f"program's {self.program.grid_shape}; compile a plan for "
                f"this grid")
        if dtype_name(state.wcon.dtype) != self.program.dtype:
            raise ValueError(
                f"state dtype {state.wcon.dtype} does not match the "
                f"program's precision policy {self.program.dtype!r}")
        if (whole and state.wcon.dim() == 4
                and int(state.wcon.shape[0]) != self.program.ensemble):
            raise ValueError(
                f"state ensemble {int(state.wcon.shape[0])} does not match "
                f"the program's ensemble={self.program.ensemble}")
        missing = [n for n in self.program.fields if n not in state.fields]
        if missing:
            raise ValueError(f"state is missing program fields {missing}")

    def _step_fn(self):
        fn = self._cache.get("step")
        if fn is None:
            fn = (_build_distributed_step(self) if self.mesh is not None
                  else self.op_def.build_local_step(self))
            self._cache["step"] = fn
        return fn


def _build_distributed_step(plan: ExecutionPlan):
    """The mesh round: the op's shard-local round over every shard of a
    `ShardedState` (the JAX package's `shard_map` of it), wcon and the slow
    tendencies passed through, and so are fields the program does not
    name (as a chain's unbound fields pass a stage)."""
    local = plan.op_def.build_shard_local(plan)

    def step(state: "_domain.ShardedState") -> "_domain.ShardedState":
        sh = state.shards
        new_fields, new_stage = local([s.fields for s in sh],
                                      [s.wcon for s in sh],
                                      [s.tens for s in sh],
                                      [s.stage_tens for s in sh])
        shards = tuple(WeatherState(fields={**s.fields, **f}, wcon=s.wcon,
                                    tens=s.tens,
                                    stage_tens={**s.stage_tens, **st})
                       for s, f, st in zip(sh, new_fields, new_stage))
        return dataclasses.replace(state, shards=shards)
    return step


def compile(program: StencilProgram, mesh: Optional[Mesh] = None, *,
            ax_e: Optional[str] = "pod", ax_y: str = "data",
            ax_x: str = "model", device=None, tune: Optional[str] = None,
            _tile: Optional[Tuple[int, int]] = None) -> ExecutionPlan:
    """Resolve `program`'s execution strategy once.

    `device` defaults to the GPU; pass `device="cpu"` to run the plain
    versions of the kernels. With `mesh` (`launch/mesh.py::make_mesh`) the
    plan runs on the mesh's devices (a `device` that names another kind is
    refused): y is split over `ax_y`, x over `ax_x`, the ensemble over
    `ax_e` where the mesh has it, and a round is the op's shard-local round
    (see the module docstring). `k_steps="auto"` resolves on a mesh to the
    exchange model's pick (`autotune.resolve_k_steps` over the op's
    declared rides and flops), walked down to what the op's CUDA k-step
    round takes (`StencilOpDef.kstep_check`); on one device to 1.
    `tune=None` / `"model"` take the kernel tile of `core/tiling.py` (the
    analytic model's window is reported, not launched: it ranks windows
    differently from the card). `tune="measure"` (the paper's "auto-tuned"
    mode) times one round at each of the op's candidate tiles on the
    plan's device (on a mesh, the mesh round) and keeps the fastest, stored
    in the disk cache of `core/autotune.py` under (program, shards,
    hardware spec, device), so a later compile measures nothing. `_tile` is
    the `(ty, tx)` request the measured path pins."""
    if not isinstance(program, StencilProgram):
        raise TypeError(f"compile wants a StencilProgram, got "
                        f"{type(program).__name__}")
    if tune not in (None, "model", "measure"):
        raise ValueError(f"tune={tune!r}: expected None, 'model', or "
                         f"'measure'")
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh= wants a launch.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        first = mesh.device_list[0]
        if device is not None and torch.device(device).type != first.type:
            raise ValueError(f"device={device!r} but the mesh's devices are "
                             f"{first.type}")
        device = first
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("compile(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device}: expected 'cuda' or 'cpu'")

    opdef = get_stencil_op(program.op)
    nz, ny, nx = program.grid_shape
    nf = program.n_fields
    halo = opdef.halo
    if mesh is not None:
        for ax in (ax_y, ax_x):
            if ax not in mesh.axis_names:
                raise ValueError(f"mesh {dict(mesh.shape)} has no axis "
                                 f"{ax!r}")
        py, px = mesh.shape[ax_y], mesh.shape[ax_x]
        if ny % py or nx % px:
            raise ValueError(f"grid (ny={ny}, nx={nx}) does not divide over "
                             f"(py={py}, px={px}) shards")
        pe = mesh.axis_size(ax_e)
        if program.ensemble % pe:
            raise ValueError(f"ensemble={program.ensemble} does not divide "
                             f"over the {pe} shards of mesh axis {ax_e!r}")
    else:
        py = px = 1
    ly, lx = ny // py, nx // px

    # steps a round: the communication-avoiding k, from the op's declared
    # flops and rides; one device has no collectives to amortize
    k = program.k_steps
    if k == "auto":
        if ("kstep" not in opdef.variants or mesh is None
                or program.variant not in ("auto", "kstep")):
            k = 1
        else:
            def exchange_model(kk):
                return memmodel.packed_exchange_model(
                    program.grid_shape, program.dtype,
                    rides=opdef.memmodel_rides(nf), k=kk, shards=(py, px),
                    compute_halo=(kk * halo, kk * halo))
            k = autotune.resolve_k_steps(
                program.grid_shape, program.dtype, (py, px), n_fields=nf,
                halo=halo, flops_per_point=opdef.flops_per_point,
                exchange_model=exchange_model,
                kstep_check=opdef.kstep_check(program, (py, px)),
                spec=hwspec.load_spec(program.hardware)
                if program.hardware else None)
    variant = program.variant
    if variant == "auto":
        variant = "kstep" if k > 1 else "whole_state"
    if variant == "kstep" and k == 1:
        variant = "whole_state"    # k resolved to 1: same round, one step
    if (program.exchange_dtype is not None
            and variant not in opdef.packed_variants):
        raise ValueError("exchange_dtype requires a packed (stacked) "
                         "exchange variant of op "
                         f"{program.op!r} ({opdef.packed_variants})")

    # the exchange schedule and the grid the kernel tiles over, from the
    # op's declared footprint
    rides = opdef.resolved_rides(k)
    hy = hx = k * halo
    pads = mesh is not None or opdef.pads_single_chip
    compute_grid = (nz, ly + 2 * hy, lx + 2 * hx) if pads else (nz, ly, lx)
    if pads:
        # a ride deeper than the local slab would need data from beyond the
        # adjacent neighbour (or, on one device, wrap more than one period)
        for name, dy, dx in rides:
            if max(dy) > ly or max(dx) > lx:
                raise ValueError(
                    f"op {program.op!r} at k_steps={k} needs a ({max(dy)}, "
                    f"{max(dx)})-deep halo for {name!r} but the local slab "
                    f"is only ({ly}, {lx}); use fewer shards, a bigger grid, "
                    f"or a smaller k_steps")
    exchange = None
    if mesh is not None:
        if variant in opdef.packed_variants:
            exchange = ExchangeSchedule(mode="packed", shards=(py, px),
                                        rides=rides,
                                        wire_dtype=program.exchange_dtype)
        else:
            # the per-operand exchange (dycore per_field/unfused): one
            # exchange an operand at one step's reach
            exchange = ExchangeSchedule(mode="per_operand", shards=(py, px),
                                        rides=opdef.resolved_rides(1),
                                        wire_dtype=None)
            compute_grid = (nz, ly + 2 * halo, lx + 2 * halo)
    tile = opdef.resolve_tile(variant, compute_grid, program.dtype, nf,
                              program.ensemble, k, _tile)
    collectives = 0
    if mesh is not None:
        collectives = (opdef.collectives(variant, nf, py, px, k)
                       if opdef.collectives is not None else None)
        if collectives is None:
            collectives = opdef.generic_collectives(py, px, k)
    plan = ExecutionPlan(
        program=program, variant=variant, k_steps=k,
        tile_ty=None if tile is None else tile.ty, tile=tile,
        local_grid=(nz, ly, lx), compute_grid=compute_grid, device=device,
        pallas_calls_per_round=opdef.pallas_calls(variant, nf, k),
        collectives_per_round=collectives, rides=rides, exchange=exchange,
        mesh=mesh, mesh_axes=(ax_e, ax_y, ax_x))
    if tune == "measure" and _tile is None:
        plan = _measured_retune(plan)
    return plan


def _recompile(plan: ExecutionPlan, program: StencilProgram,
               **kw) -> ExecutionPlan:
    """`compile(program)` on `plan`'s device or mesh and axes."""
    ax_e, ax_y, ax_x = plan.mesh_axes
    return compile(program, mesh=plan.mesh, ax_e=ax_e, ax_y=ax_y, ax_x=ax_x,
                   device=plan.device, **kw)


# The dycore entry point of the JAX package: the same planner.
compile_dycore = compile


def reference_program(program: StencilProgram) -> StencilProgram:
    """`program` rebound to its op's reference lowering: the unfused
    (oracle) variant when the op declares one, one step a round, no wire
    compression — the most conservative availability fallback. On the card
    it runs the plain torch ops and launches no kernel; its numerics are
    the same physics but not bit-equal to the kernelled variants, so a
    caller that degrades this far must say so (`compile_with_fallback`)."""
    opdef = get_stencil_op(program.op)
    ref = "unfused" if "unfused" in opdef.variants else opdef.variants[0]
    return dataclasses.replace(program, variant=ref, k_steps=1,
                               exchange_dtype=None)


def compile_with_fallback(program: StencilProgram,
                          mesh: Optional[Mesh] = None, *,
                          ax_e: Optional[str] = "pod", ax_y: str = "data",
                          ax_x: str = "model", device=None,
                          attempt_hook=None
                          ) -> Tuple[ExecutionPlan, Optional[str], list]:
    """`compile` with an explicit, counted degradation chain over

      1. ``native``    — the program exactly as asked (the kernels);
      2. ``reference`` — `reference_program(program)`: the op's unfused
         plan, one step a round (availability over bit-identity — the last
         resort, and the one place a plain version stands in for a kernel).

    The JAX package's middle ``interpret`` stage (the same plan through the
    Pallas interpreter) has no counterpart: the port has no interpreter.
    Returns ``(plan, fallback, errors)``: `fallback` is None when the native
    attempt won, else ``"reference"``; `errors` lists ``(stage,
    repr(exc))`` for every failed attempt. Raises once both stages fail.
    `attempt_hook(program, stage)` is the fault-injection seam
    (`testing.faults.FaultInjector.on_compile`). `compile` itself never
    falls back.

    On the CPU, where every plan runs the plain versions, any failure
    degrades, as in the JAX package. On the card only an injected fault
    (`testing.faults.InjectedFault`, the rehearsal seam) degrades: a real
    failure to compile the kernelled plan propagates, so no kernel is ever
    silently replaced by the plain ops."""
    from repro_torch.testing.faults import InjectedFault
    if mesh is not None:
        on_card = mesh.device_type != "cpu"
    else:
        on_card = torch.device(device or "cuda").type != "cpu"
    attempts = [("native", program), ("reference", reference_program(program))]
    errors: list = []
    last = None
    for stage, prog in attempts:
        try:
            if attempt_hook is not None:
                attempt_hook(prog, stage)
            axes = ({} if mesh is None
                    else {"ax_e": ax_e, "ax_y": ax_y, "ax_x": ax_x})
            plan = compile(prog, mesh=mesh, device=device, **axes)
            return plan, (None if stage == "native" else stage), errors
        except Exception as e:  # noqa: BLE001 — see the rule above
            if on_card and not isinstance(e, InjectedFault):
                raise
            errors.append((stage, repr(e)))
            last = e
    raise RuntimeError(
        f"compile fallback chain exhausted for op={program.op!r}: "
        f"{errors}") from last


def _measured_retune(plan: ExecutionPlan) -> ExecutionPlan:
    """The `tune="measure"` path: the candidate tile that ran a round
    fastest on the plan's device (on a mesh, the mesh round), looked up in
    the disk cache by (program, shards, hardware spec, device) or measured
    once and stored; the plan recompiled with that tile pinned."""
    if plan.tile is None:
        return plan               # the unfused oracle has no tile to tune
    program = plan.program
    spec = plan.hardware_spec()
    backend = autotune.backend_name(plan.device)
    key = autotune.tune_cache_key((plan_cache_key(program), plan.shards),
                                  spec, backend)
    entry = autotune.tune_cache_load(key)
    cached = entry is not None
    if entry is None:
        entry = _measure_tile_candidates(plan)
        entry.update({"backend": backend, "spec": spec.name,
                      "spec_fingerprint": spec.fingerprint,
                      "k_steps": plan.k_steps})
        autotune.tune_cache_store(key, entry)
    tuned = _recompile(plan, program,
                       _tile=tuple(int(t) for t in entry["tile"]))
    tuned._cache["tuning"] = {"mode": "measure", "cached": cached, **entry}
    return tuned


# `tune="measure"` times at most MAX_MEASURED candidate tiles (the JAX
# package's bound), each the median of MEASURE_REPEATS rounds: on the H100
# a median of 3 moved a round's time by up to 10% between a tile's own
# calls, more than the tiles differ (PERF.md §6)
MAX_MEASURED = 8
MEASURE_REPEATS = 10


def _measure_tile_candidates(plan: ExecutionPlan) -> Dict[str, Any]:
    """Time one round (`autotune.measure_walltime`) at each of the op's
    kernel tile candidates, at most MAX_MEASURED spread over the list (the
    default first), on an all-zero state on the plan's device or mesh;
    return the cache entry. Only a ValueError of the planner, refusing a pinned
    request, scores a candidate `inf`: a kernel that fails to build or
    launch raises."""
    program = plan.program
    cands = plan.op_def.cuda_tile_candidates(
        plan.variant, plan.compute_grid, program.dtype, program.n_fields,
        plan.k_steps)
    if len(cands) > MAX_MEASURED:
        stride = len(cands) / MAX_MEASURED
        cands = [cands[int(i * stride)] for i in range(MAX_MEASURED)]
    state = zeros_state(program.grid_shape, program.ensemble, program.dtype,
                        names=program.fields,
                        device="cpu" if plan.mesh else plan.device)
    if plan.mesh is not None:
        state = _domain.shard_state(state, plan.mesh, plan.state_spec)
    timed = {}
    for request, tile in cands:
        try:
            cp = _recompile(plan, program, _tile=request)
        except ValueError:
            timed[request] = (tile, math.inf)
            continue
        timed[request] = (tile, autotune.measure_walltime(
            lambda: cp.step(state), repeats=MEASURE_REPEATS,
            device=plan.device))
    best = min(timed, key=lambda r: timed[r][1])
    name = lambda t: f"{t.ty}x{t.tx}"
    return {"tile": list(best),
            "kernel_tile": name(timed[best][0]),
            "default_tile": name(cands[0][1]),
            "measured_s": timed[best][1],
            "measured": {name(t): sec for t, sec in timed.values()}}
