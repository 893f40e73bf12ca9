"""Declarative stencil programs on one device: spec -> plan -> launch.

A port of `repro.weather.program` for a single device:

* `StencilProgram` is the *what*: the registered op (`"dycore"`, `"hdiff"`,
  `"vadvc"`, `"hadv_upwind"`), grid, ensemble, field set, precision and
  step policy. It keeps the JAX package's checks, and `to_json` /
  `from_json` round-trip with the JAX package's JSON.
* `compile(program, device="cuda")` is the planner: it resolves the
  execution variant, the kernel tile and the launch count per round once.
* `ExecutionPlan` is the *how*: `step(state)` advances one round of
  `k_steps` timesteps, `run(state, steps)` runs `steps // k_steps` rounds and
  one shorter tail round (`round_plan(steps % k_steps)`), `report()` returns
  the structural strategy under the JAX package's key names and the
  paper's cross-machine table (`model_by_hardware`).

What runs is decided by the plan's device: on CUDA every kernelled variant
launches the hand-written kernels (a k-step round is ONE launch of the
k-step kernel); on the CPU the same lowering takes their plain versions.
Not yet ported, each raising `NotImplementedError`: meshes (ROADMAP queue
1, item 6), `tune="measure"` (item 2), `hardware=` and the `model` /
`traffic` blocks of `report()` (item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import autotune, hwspec, perfmodel, tiling
from repro_torch.weather import stencil_ops as _sops
from repro_torch.weather.fields import PROGNOSTIC, WeatherState, dtype_name
from repro_torch.weather.stencil_ops import (StencilOpDef, get_stencil_op,
                                             register_stencil_op,
                                             registered_stencil_ops)

VARIANTS = _sops.VARIANTS
# The hardware specs the port ships (`repro_torch/specs/*.json`); a program
# naming one is valid, though `compile(hardware=...)` is not ported yet.
KNOWN_HARDWARE = hwspec.available_specs()

__all__ = ["StencilProgram", "ExecutionPlan", "compile",
           "StencilOpDef", "get_stencil_op",
           "register_stencil_op", "registered_stencil_ops", "VARIANTS"]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               f"(ROADMAP.md queue 1, {item})")


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
                             f"no k-step round")
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
        if "stages" in d:
            raise _not_ported("PipelineProgram", "item 5")
        d["grid_shape"] = tuple(d["grid_shape"])
        d["fields"] = tuple(d["fields"])
        return cls(**d)


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether `a` and `b` name one device (`cuda` matches `cuda:0`)."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The *how*: an immutable, fully resolved single-device strategy."""

    program: StencilProgram
    variant: str                                # resolved, never "auto"
    k_steps: int                                # resolved timesteps a round
    tile_ty: Optional[int]                      # None for unfused
    tile: Optional[tiling.CudaTile]             # None for unfused
    local_grid: Tuple[int, int, int]
    compute_grid: Tuple[int, int, int]          # grid the kernel tiles over
    device: torch.device
    pallas_calls_per_round: int                 # kernel launches per round
    collectives_per_round: int
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def op_def(self) -> StencilOpDef:
        return get_stencil_op(self.program.op)

    def step(self, state: WeatherState) -> WeatherState:
        """Advance ONE round (`k_steps` timesteps)."""
        self._check_state(state)
        return self._step_fn()(state)

    def run(self, state: WeatherState, steps: int) -> WeatherState:
        """Advance `steps` timesteps: `steps // k_steps` full rounds plus,
        when `steps % k_steps != 0`, one shorter tail round through
        `round_plan(steps % k_steps)`."""
        if not isinstance(steps, int) or steps < 0:
            raise ValueError(f"steps={steps!r} must be a non-negative int")
        self._check_state(state)
        rounds, tail = divmod(steps, self.k_steps)
        step = self._step_fn()
        for _ in range(rounds):
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
            plan = compile(dataclasses.replace(self.program, variant="auto",
                                               k_steps=k), device=self.device)
            self._cache[("tail", k)] = plan
        return plan

    def report(self) -> Dict[str, Any]:
        """The structural strategy under the JAX package's key names and
        the cross-machine table `model_by_hardware`. The `model` and
        `traffic` blocks are not ported yet (ROADMAP queue 1, item 4)."""
        prog = self.program
        return {
            "op": prog.op,
            "program": prog.to_json(),
            "variant": self.variant,
            "k_steps": self.k_steps,
            "footprint": self.op_def.describe(prog.n_fields, self.k_steps),
            "tile": (None if self.tile is None
                     else {"ty": self.tile_ty, **self.tile.describe()}),
            "device": str(self.device),
            "distributed": False,
            "local_grid": list(self.local_grid),
            "compute_grid": list(self.compute_grid),
            "exchange": None,
            "pallas_calls_per_round": self.pallas_calls_per_round,
            "collectives_per_round": self.collectives_per_round,
            "model_by_hardware": self.model_by_hardware(),
        }

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

    def _check_state(self, state: WeatherState) -> None:
        if state.grid_shape != self.program.grid_shape:
            raise ValueError(
                f"state grid {state.grid_shape} does not match the "
                f"program's {self.program.grid_shape}; compile a plan for "
                f"this grid")
        if dtype_name(state.wcon.dtype) != self.program.dtype:
            raise ValueError(
                f"state dtype {state.wcon.dtype} does not match the "
                f"program's precision policy {self.program.dtype!r}")
        if (state.wcon.dim() == 4
                and int(state.wcon.shape[0]) != self.program.ensemble):
            raise ValueError(
                f"state ensemble {int(state.wcon.shape[0])} does not match "
                f"the program's ensemble={self.program.ensemble}")
        if not same_device(state.device, self.device):
            raise ValueError(f"state is on {state.device} but the plan was "
                             f"compiled for {self.device}")
        missing = [n for n in self.program.fields if n not in state.fields]
        if missing:
            raise ValueError(f"state is missing program fields {missing}")

    def _step_fn(self):
        fn = self._cache.get("step")
        if fn is None:
            fn = self.op_def.build_local_step(self)
            self._cache["step"] = fn
        return fn


def compile(program: StencilProgram, mesh=None, *, device="cuda",
            tune: Optional[str] = None) -> ExecutionPlan:
    """Resolve `program`'s single-device execution strategy once.

    `device` defaults to the GPU; pass `device="cpu"` to run the plain
    versions of the kernels. `tune=None` / `"model"` take the fixed tile of
    `core/tiling.py`."""
    if not isinstance(program, StencilProgram):
        raise TypeError(f"compile wants a StencilProgram, got "
                        f"{type(program).__name__}")
    if tune not in (None, "model", "measure"):
        raise ValueError(f"tune={tune!r}: expected None, 'model', or "
                         f"'measure'")
    if mesh is not None:
        raise _not_ported("mesh= (distributed rounds)", "item 6")
    if tune == "measure":
        raise _not_ported("tune='measure'", "item 2")
    if program.hardware is not None:
        raise _not_ported("hardware= (modeled numbers)", "item 4")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("compile(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device}: expected 'cuda' or 'cpu'")

    opdef = get_stencil_op(program.op)
    nz, ny, nx = program.grid_shape
    nf = program.n_fields
    # One device: no collectives to amortize, so "auto" is one step a round.
    k = 1 if program.k_steps == "auto" else program.k_steps
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
    rides = opdef.resolved_rides(k)
    hy = hx = k * opdef.halo
    compute_grid = ((nz, ny + 2 * hy, nx + 2 * hx) if opdef.pads_single_chip
                    else program.grid_shape)
    if opdef.pads_single_chip:
        for name, dy, dx in rides:
            if max(dy) > ny or max(dx) > nx:
                raise ValueError(
                    f"op {program.op!r} at k_steps={k} needs a ({max(dy)}, "
                    f"{max(dx)})-deep halo for {name!r} but the grid is "
                    f"only ({ny}, {nx}); use a bigger grid or a smaller "
                    f"k_steps")
    tile = opdef.resolve_tile(variant, compute_grid, program.dtype, nf,
                              program.ensemble, k)
    return ExecutionPlan(
        program=program, variant=variant, k_steps=k,
        tile_ty=None if tile is None else tile.ty, tile=tile,
        local_grid=(nz, ny, nx), compute_grid=compute_grid, device=device,
        pallas_calls_per_round=opdef.pallas_calls(variant, nf, k),
        collectives_per_round=0)
