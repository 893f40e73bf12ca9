"""Traffic kind `forecast_runs`: forecasts of a fixed length, back to back,
each from a fresh initial state, as an ensemble suite starts a forecast
from each new analysis.

A mix of this kind is a data file (`traffic/<mix>.json`) with:

* `op`: the registered stencil op the program runs (`ops/<op>.py` holds
  its cost and plain reference);
* `steps_per_forecast`: N, the steps of one forecast;
* `pool_gib`: set-up draws P = max(1, pool_gib GiB // one state's bytes)
  initial states on the device from the seed, and forecast j starts from
  state j % P (`plan.run` never writes its input).

A step counts when its forecast's synchronise returns. The window runs
whole forecasts until `seconds` have passed, so it ends at the end of the
forecast that crossed that mark, and the rate is taken over all of it.

The check compares `KEPT_FORECASTS` finished forecasts of the window,
drawn from the seed uniformly over all of them (a reservoir), and of each
`CHECKED_MEMBERS` ensemble members, one drawn from each of that many equal
slices of the ensemble, so a fault in any part of the batch shows. Its
numbers (`NUMBERS`, `leaf_gaps`) are held to the cell's
`limits/<cell>.json`.
"""

from __future__ import annotations

import contextlib
import math
import random
import statistics
import time
from typing import Any, Dict, List

import torch

from bench import devtrace, inputs, manifest, peaks

KEPT_FORECASTS = 2            # forecasts the check compares
CHECKED_MEMBERS = 2           # members of each, one from each slice
WARMUP_STEPS = 3              # set-up's steps, so the window builds nothing
TRACE_TARGET_S = 2.0          # the traced stretch: whole forecasts, ~2 s
DISPATCH_STEPS = 32           # steps a dispatch sample enqueues
DISPATCH_HOST_S = 0.25        # host time the dispatch samples add up to
DISPATCH_WALL_S = 3.0         # ... or the wall time they may take
NUMBERS = ("state_gap", "state_rms_gap")


class Workload:
    """One run of a cell under this traffic kind."""

    def __init__(self, cell, seed: int, device: str):
        self.cell = cell
        self.cfg = cell.config
        self.mix = cell.traffic
        self.op = manifest.op(cell.root, self.mix["op"])
        self.seed = int(seed)
        self.device = torch.device(device)
        self.grid = (self.cfg["nz"], self.cfg["ny"], self.cfg["nx"])
        self.members = int(self.cfg["members"])
        self.names = tuple(self.cfg["fields"])
        self.dtype_name = self.cfg["dtype"]
        self.dtype = inputs.DTYPES[self.dtype_name]
        self.steps = int(self.mix["steps_per_forecast"])
        rng = random.Random(self.seed)
        self.checked = _strata(rng, self.members, CHECKED_MEMBERS)
        self.reservoir_rng = random.Random(rng.getrandbits(64))
        self.kept: List[tuple] = []          # (forecast j, members' state)
        self.done = 0                        # forecasts finished
        self.plan = None
        self.pool_size = 0
        self.pool: List[Dict[str, torch.Tensor]] = []
        self.program_states: list = []       # the pool as program states
        self.starts: Dict[int, Dict[str, torch.Tensor]] = {}
        self._checked_idx = None
        self.forecast_s = 0.0                # the window's time a forecast

    # -- what the metric readers read ---------------------------------------
    @property
    def n_fields(self) -> int:
        return len(self.names)

    @property
    def itemsize(self) -> int:
        return peaks.itemsize(self.dtype_name)

    @property
    def points(self) -> int:
        """Grid points a step updates: members x nz x ny x nx."""
        nz, ny, nx = self.grid
        return self.members * nz * ny * nx

    def step_bound_s(self) -> float:
        """The whole step's least time at the chip's peaks, from the op's
        own bytes and operations."""
        return peaks.bound_s(
            self.op.step_bytes(self.grid, self.members, self.n_fields,
                               self.itemsize),
            self.op.step_flops(self.grid, self.members, self.n_fields),
            self.dtype_name)

    # -- set-up ------------------------------------------------------------
    def draw_inputs(self) -> None:
        one = inputs.state_bytes(self.grid, self.members, self.n_fields,
                                 self.dtype)
        self.pool_size = max(1, int(float(self.mix["pool_gib"]) * 2**30)
                             // one)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        self.pool = [inputs.draw_state(gen, self.grid, self.members,
                                       self.n_fields, self.dtype)
                     for _ in range(self.pool_size)]
        self.program_states = [self._program_state(s) for s in self.pool]
        self._checked_idx = torch.as_tensor(self.checked, dtype=torch.long,
                                            device=self.device)
        self._sync()

    def compile(self) -> None:
        from repro_torch.weather.program import StencilProgram, compile
        cfg = self.cfg
        program = StencilProgram(
            grid_shape=self.grid, ensemble=self.members, fields=self.names,
            dtype=cfg["dtype"], boundary=cfg["boundary"], coeff=cfg["coeff"],
            dt=cfg["dt"], variant=cfg["variant"], k_steps=cfg["k_steps"],
            op=self.mix["op"])
        self.plan = compile(program, device=str(self.device), tune=cfg["tune"])

    def warm_up(self) -> None:
        out = self.plan.run(self.program_states[0], WARMUP_STEPS)
        self._members(out)
        self._sync()

    # -- the timed path ----------------------------------------------------
    def forecast(self, state):
        """The timed call: one forecast of the mix's steps."""
        return self.plan.run(state, self.steps)

    def one(self, span=None, keep: bool = True) -> None:
        """Forecast number `done` from its pool state, synchronised, then,
        with `keep`, offered to the reservoir of kept answers."""
        span = span or (lambda name: contextlib.nullcontext())
        j = self.done
        with span("bench.run"):
            out = self.forecast(self.program_states[j % self.pool_size])
        with span("bench.sync"):
            self._sync()
        if keep:
            with span("bench.keep"):
                self._offer(j, out)
        self.done += 1

    def measure(self, seconds: float) -> Dict[str, float]:
        from repro_torch.kernels import _build
        launches = sum(_build.LAUNCHES.values())
        first, t0 = self.done, time.perf_counter()
        while True:
            self.one()
            window_s = time.perf_counter() - t0
            if window_s >= seconds:
                break
        forecasts = self.done - first
        self.forecast_s = window_s / forecasts
        return {"window_s": window_s, "attempted": forecasts,
                "forecasts": forecasts,
                "steps": forecasts * self.steps,
                "launches": sum(_build.LAUNCHES.values()) - launches}

    def traced(self) -> devtrace.Trace:
        """Whole forecasts under the profiler, about `TRACE_TARGET_S` at the
        window's time a forecast (`measure` runs first). They
        keep no answers (the check samples the window's), so the trace
        holds the program's device operations and none of the benchmark's
        copies."""
        from torch.profiler import record_function
        n = max(1, round(TRACE_TARGET_S / max(self.forecast_s, 1e-9)))

        def body():
            for _ in range(n):
                self.one(record_function, keep=False)
        tr = devtrace.profiled(body)
        tr.attempted, tr.steps = n, n * self.steps
        return tr

    def dispatch_s(self) -> float:
        """Host seconds to enqueue one step: `plan.run` of
        `DISPATCH_STEPS` steps on an idle device, timed until it returns,
        summed over samples until they add up to `DISPATCH_HOST_S` (or
        take `DISPATCH_WALL_S`)."""
        state = self.program_states[0]
        host, steps, t_end = 0.0, 0, time.perf_counter() + DISPATCH_WALL_S
        while steps < 2 * DISPATCH_STEPS or (
                host < DISPATCH_HOST_S and time.perf_counter() < t_end):
            self._sync()
            t0 = time.perf_counter()
            self.plan.run(state, DISPATCH_STEPS)
            host += time.perf_counter() - t0
            steps += DISPATCH_STEPS
        self._sync()
        return host / steps

    # -- the check ---------------------------------------------------------
    def release(self) -> None:
        """Free the program's state, keeping the checked members of the
        initial states the kept forecasts started from."""
        for j, _ in self.kept:
            p = j % self.pool_size
            if p not in self.starts:
                self.starts[p] = inputs.members_of(self.pool[p], self.checked)
        self.pool, self.program_states, self.plan = [], [], None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> Dict[str, Any]:
        """Compare each kept forecast's checked members with the plain
        reference run from the same initial state. With `control`, the
        control (`control`) stands in the program's place. Returns each
        number's largest reading over the kept forecasts (`numbers`) and
        each kept forecast's `(j, {number: reading})` (`answers`)."""
        per, refs, stand = [], {}, {}
        for j, got in self.kept:
            p = j % self.pool_size
            if p not in refs:
                refs[p] = self.reference(self.starts[p])
                if control:
                    stand[p] = self.control(self.starts[p])
            if control:
                got = stand[p]
            gaps = leaf_gaps(got, refs[p])
            per.append((j, {k: max(gaps[k]) for k in NUMBERS}))
        numbers = {k: max((g[k] for _, g in per), default=math.inf)
                   for k in NUMBERS}
        return {"numbers": numbers, "answers": per}

    def reference(self, start) -> Dict[str, torch.Tensor]:
        """The plain reference of one forecast from `start` (checked
        members)."""
        return self.reference_steps(start, self.steps)

    def reference_steps(self, state, steps: int) -> Dict[str, torch.Tensor]:
        """`steps` steps of the op's plain reference from `state`."""
        for _ in range(steps):
            state = self.op.reference_step(state, self.cfg["coeff"],
                                           self.cfg["dt"])
        return state

    def control(self, start) -> Dict[str, torch.Tensor]:
        """The control of the check: the program's own bfloat16 path, one
        precision below the configuration's float32, run on the same
        checked members of the same initial state (members are
        independent, so an ensemble of the checked members alone steps
        them as the whole ensemble would)."""
        from repro_torch.weather.program import StencilProgram, compile
        cfg = self.cfg
        plan = compile(StencilProgram(
            grid_shape=self.grid, ensemble=len(self.checked),
            fields=self.names, dtype="bfloat16", boundary=cfg["boundary"],
            coeff=cfg["coeff"], dt=cfg["dt"], variant=cfg["variant"],
            k_steps=cfg["k_steps"], op=self.mix["op"]),
            device=str(self.device), tune=cfg["tune"])
        state = {g: t.to(torch.bfloat16) for g, t in start.items()}
        out = plan.run(self._program_state(state), self.steps)
        return self._members(out, range(len(self.checked)))

    # -- helpers -----------------------------------------------------------
    def _offer(self, j: int, out) -> None:
        if len(self.kept) < KEPT_FORECASTS:
            self.kept.append((j, self._members(out)))
            return
        i = self.reservoir_rng.randrange(j + 1)
        if i < KEPT_FORECASTS:
            self.kept[i] = (j, self._members(out))

    def _members(self, out, members=None) -> Dict[str, torch.Tensor]:
        """A copy of the checked (or the given) members of a program state,
        as field-stacked tensors."""
        if members is None:
            idx = self._checked_idx
        else:
            idx = torch.as_tensor(list(members), dtype=torch.long,
                                  device=out.wcon.device)
        pick = lambda t: t.index_select(0, idx)
        stack = lambda d: torch.stack([pick(d[n]) for n in self.names], 1)
        return {"fields": stack(out.fields), "wcon": pick(out.wcon),
                "tens": stack(out.tens), "stage_tens": stack(out.stage_tens)}

    def _program_state(self, s):
        from repro_torch.weather.fields import WeatherState, field_views
        return WeatherState(fields=field_views(s["fields"], self.names),
                            wcon=s["wcon"],
                            tens=field_views(s["tens"], self.names),
                            stage_tens=field_views(s["stage_tens"],
                                                   self.names))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def leaf_gaps(got: Dict[str, torch.Tensor],
              want: Dict[str, torch.Tensor]) -> Dict[str, List[float]]:
    """Per leaf (each field of each field-stacked group, and wcon), two
    gaps of `got` from `want`, each over the reference's size of that leaf
    or of the median leaf, whichever is larger (a leaf that is all but
    zero, as the stage tendencies before a step, is not divided by ~0):

    * `state_gap`: the largest |got - want| over the largest |want|;
    * `state_rms_gap`: the root mean square of got - want over that of
      want, which a few limiter branches that flip on rounding barely
      move and an error spread over the whole state does.

    A gap that is not finite reads inf."""
    sizes = {k: [] for k in NUMBERS}
    diffs = {k: [] for k in NUMBERS}
    rms = lambda t: float(t.square().mean().sqrt())
    for g in inputs.GROUPS:
        w, o = want[g].float(), got[g].float()
        pairs = ([(o, w)] if g == "wcon"
                 else list(zip(o.unbind(1), w.unbind(1))))
        for a, b in pairs:
            d = a - b
            diffs["state_gap"].append(float(d.abs().max()))
            sizes["state_gap"].append(float(b.abs().max()))
            diffs["state_rms_gap"].append(rms(d))
            sizes["state_rms_gap"].append(rms(b))
    out = {}
    for key in NUMBERS:
        mid = statistics.median(sizes[key])
        gaps = []
        for d, s in zip(diffs[key], sizes[key]):
            scale = max(s, mid)
            gap = d / scale if scale > 0 else (0.0 if d == 0 else math.inf)
            gaps.append(gap if math.isfinite(gap) else math.inf)
        out[key] = gaps
    return out


def _strata(rng: random.Random, members: int, n: int) -> List[int]:
    """One member drawn from each of `n` equal slices of the ensemble."""
    n = max(1, min(n, members))
    bounds = [members * i // n for i in range(n + 1)]
    return [rng.randrange(bounds[i], bounds[i + 1]) for i in range(n)]
