"""Forecast-as-a-service: a continuous-batching ensemble serving engine.

A port of `repro.serve.forecast`, on one device or a mesh. An operational
forecast service runs the SAME compiled stencil programs for many
concurrent consumers — requests differ only in initial state and step
count. This engine is that service layer over the plan API
(`weather/program.py`):

* **Plan cache, compile once / serve forever.** Every request names a
  `StencilProgram` (ensemble 1 — one forecast). The engine canonicalizes it
  with `program.plan_cache_key(prog, ensemble=slots)` and compiles at most
  ONE `ExecutionPlan` per distinct program.

* **Continuous batching into the ensemble axis.** The `(e, ...)` axis is
  already the batch dimension of every kernel, so admission writes a
  request into a free slot of a zero-initialized lane (in place, keeping
  the lane's field-stacked layout, so the whole-state kernel takes it
  without a copy), and each engine round is ONE `plan.step` for up to
  `slots` concurrent forecasts. Finished slots retire at round boundaries
  and are backfilled from the queue.

* **Bit-identical to solo runs.** Serving a request batched is bit-equal to
  `compile(program).run(state, steps)` at ensemble 1: members are computed
  independently (no cross-slot arithmetic; no kernel's tile depends on the
  ensemble), and every request advances through exactly the round sequence
  a solo `run()` would — `floor(steps/k)` full rounds plus one ragged tail,
  through the plan's `round_plan(k')`. A slot whose next canonical part is
  deeper than the round runs along and is ROLLED BACK
  (`ensemble_slot_select`, in place) and not credited.

* **Host I/O overlaps device compute.** `submit` stages the request's
  arrays onto the device at once (`.to(device, non_blocking=True)` from
  pinned host memory), so by the time a slot frees its data is resident.
  Retirement reads back exactly one slot; a result's `state` holds CPU
  tensors (numpy has no bfloat16).

* **On a mesh.** With `mesh=` (`launch/mesh.py::make_mesh`) a lane's
  batch is a `domain.ShardedState` on its plan's `state_spec`: y over
  `ax_y`, x over `ax_x`, the slots over `ax_e` where the mesh has it. A
  round is the plan's mesh round; admission, rollback and scrub write each
  shard's own block in place; a retiring slot is gathered from the shards
  that hold it. The lanes live on the mesh's devices and nothing moves to
  the CPU unless the mesh is of CPU devices.

* **Warm restarts, on any mesh.** `checkpoint()` persists the whole engine
  — lanes (gathered whole), queue, finished results, per-request
  bookkeeping and each lane's resolved round strategy — through
  `ckpt.save_tree`, in the JAX package's layout (either package restores
  the other's checkpoints); `ForecastEngine.restore(..., mesh=)` resumes
  mid-forecast on whatever device or mesh it is given, each lane resharded
  through the new plan's `state_spec` after its round-strategy pin is
  seeded, falling back past a corrupt newest checkpoint.

* **Supervised.** At every round boundary the slot-guard kernel
  (`program.slot_guard`: one launch on one device; on a mesh one partial
  launch a distinct block and one combine) gives each slot a validity bit
  (NaN/Inf and `|x| <= guard_limit`) and a digest of its exact bits, the
  same however the lane is sharded. An invalid
  slot is QUARANTINED (its request fails with a per-leaf diagnosis, the
  slot is zeroed and backfills); slots that did not advance a round
  (rolled back, idle) must keep their digest, or they count as divergent.
  A failed round retries with exponential backoff, then fails only that
  lane's requests. `max_queue` bounds the queue (`QueueFullError`),
  `deadline_s` expires stale work, `round_deadline_s` fails a straggling
  round, `ckpt_every_rounds` checkpoints at round boundaries, and plan
  compilation goes through `program.compile_with_fallback` (native, then
  the op's reference plan; on the card only for an injected fault, so a
  real compile error propagates), counted in `stats()`.

* **Mesh failover.** When a round's retries run out on a mesh and a
  device is identifiably lost — named by the error (`lost_device`, a
  logical id of `launch.mesh.Mesh.ids`) or found dead by a probe of each
  logical device — the engine gathers every lane's pre-round batch (the
  last round boundary: a round writes new tensors, never its input),
  walks `domain.failover_meshes` over the survivors best first until
  every lane's plan compiles with its pinned round strategy, reshards and
  re-runs the interrupted round; `stats()` records `mesh_failovers`,
  `recovery_rounds`, `requests_preserved` and each failover. It moves
  work only to surviving devices of the mesh's kind, never to the CPU. A
  round that fails for any other reason fails its lane.

Every path is driven by `testing.faults.FaultInjector`.

Differences from the JAX package: the compile chain has no interpreter
stage, so when retries run out (and no failover applies) a lane fails,
as the JAX package's does on its interpreter. A retiring slot is zeroed
at once (the JAX package leaves its last state to step along idle, and
its next round's fingerprint check then counts a divergence and scrubs
it), so a fault-free drain scrubs nothing. A mesh's devices are named by
logical ids (several shards may share one card), and the probe's tiny
transfer, add and readback go to each logical device. The port's mesh
rounds are bit for bit the single-device plan's at the same round
strategy (the same kernels on the same inputs at every point), so a
failover that collapses a sharded axis keeps results bit for bit where
the JAX package's does not. On the CPU in bf16 a mesh round sums w in the
storage dtype and the single-device plan in fp32, so there results keep
the original mesh's bits, not the single-device plan's.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch.mesh import Mesh
from repro_torch.weather import domain as _domain
from repro_torch.weather import fields as _fields
from repro_torch.weather import program as _wprog
from repro_torch.weather.fields import WeatherState, dtype_name

__all__ = ["ForecastRequest", "ForecastResult", "ForecastEngine",
           "QueueFullError", "RoundDeadlineError", "STATUSES"]

# Result statuses:
#   ok       — served; state is bit-identical to the solo run
#   failed   — quarantined by the validity guard or a persistent round
#              failure; `diagnosis` says why, `state` is the last state
#   expired  — per-request deadline passed before completion
STATUSES = ("ok", "failed", "expired")


class QueueFullError(RuntimeError):
    """`submit()` refused a request: the bounded queue is full. Explicit
    backpressure — retry later or raise `max_queue`."""


class RoundDeadlineError(RuntimeError):
    """A round attempt exceeded `round_deadline_s`; it escalates through the
    same retry ladder as any other round failure."""


@dataclasses.dataclass
class ForecastRequest:
    """One forecast: a program (the *what*, ensemble 1), its initial state
    ((1, nz, ny, nx) leaves), and how many timesteps to advance."""

    program: _wprog.StencilProgram
    state: WeatherState
    steps: int
    rid: Optional[int] = None                   # assigned by submit()
    deadline_s: Optional[float] = None          # wall-clock budget from submit

    def validate(self) -> None:
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(f"deadline_s={self.deadline_s!r} must be a "
                             f"positive number of seconds (or None)")
        if self.program.ensemble != 1:
            raise ValueError(f"a request is ONE forecast: program.ensemble "
                             f"must be 1, got {self.program.ensemble}")
        if not isinstance(self.steps, int) or self.steps < 0:
            raise ValueError(f"steps={self.steps!r} must be a "
                             f"non-negative int")
        if self.state.grid_shape != self.program.grid_shape:
            raise ValueError(f"state grid {self.state.grid_shape} != "
                             f"program grid {self.program.grid_shape}")
        if dtype_name(self.state.wcon.dtype) != self.program.dtype:
            raise ValueError(f"state dtype {self.state.wcon.dtype} != "
                             f"program dtype {self.program.dtype}")
        if set(self.state.fields) != set(self.program.fields):
            raise ValueError(f"state fields {sorted(self.state.fields)} != "
                             f"program fields {sorted(self.program.fields)}")
        if int(self.state.wcon.shape[0]) != 1:
            raise ValueError("request state must have a leading ensemble "
                             "dim of 1")


@dataclasses.dataclass
class ForecastResult:
    """A finished forecast: the final state (CPU tensors) plus per-request
    accounting — `latency_s` is THIS request's admit-to-finish wall time,
    `queue_wait_s` the time it sat unadmitted."""

    rid: int
    program: _wprog.StencilProgram
    state: WeatherState                         # (1, ...) leaves, on the CPU
    steps: int
    latency_s: float
    queue_wait_s: float
    rounds: int
    status: str = "ok"                          # one of STATUSES
    steps_done: Optional[int] = None            # == steps when status=="ok"
    diagnosis: Optional[Dict[str, Any]] = None  # why, when status != "ok"

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class _Slot:
    rid: int
    remaining: int
    steps: int
    admit_t: float
    queue_wait_s: float
    rounds: int = 0
    deadline_s: Optional[float] = None

    @property
    def submit_t(self) -> float:
        return self.admit_t - self.queue_wait_s


@dataclasses.dataclass
class _Lane:
    """One plan's batch: all slots share the lane's compiled plan."""

    key: _wprog.StencilProgram                  # canonical, ensemble=slots
    # (slots, nz, ny, nx) leaves; on a mesh a domain.ShardedState
    batch: Any
    slots: List[Optional[_Slot]]
    # Per-slot content digests recorded at round boundaries (slot index ->
    # uint32 as int). Sharding-invariant, so they survive a failover
    # reshard and keep guarding across it. Entries are dropped whenever a
    # slot's bits legitimately get new content (admit, scrub, retire).
    fps: Dict[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Pending:
    request: ForecastRequest
    submit_t: float
    counted: bool = False       # plan-cache hit/miss recorded once only


def _host(state: WeatherState) -> WeatherState:
    """A copy of `state` on the CPU, sharing nothing with the engine."""
    return _wprog.map_state(state,
                            lambda t: t.detach().to("cpu", copy=True))


def _stage(state: WeatherState, device: torch.device) -> WeatherState:
    """`state` on `device`: host tensors go through pinned memory and a
    non-blocking copy, so staging overlaps whatever round is running."""
    def put(t):
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return _wprog.map_state(state, put)


class ForecastEngine:
    """Continuous-batching forecast service over cached ExecutionPlans.

    `submit()` enqueues (and stages arrays onto the device), `pump()`
    admits + advances every busy lane one round, `drain()` pumps until
    idle and returns `{rid: ForecastResult}`. `checkpoint()` /
    `ForecastEngine.restore()` persist and resume the warm engine. Runs on
    the card unless `device="cpu"` (the kernels' plain versions); with
    `mesh=`, on the mesh's devices (a `device` of another kind raises),
    sharded over `ax_e` / `ax_y` / `ax_x`, failing over to survivors on a
    persistent device loss unless `failover=False`."""

    def __init__(self, slots: int = 4, mesh: Optional[Mesh] = None,
                 device=None, ax_e: Optional[str] = "pod",
                 ax_y: str = "data", ax_x: str = "model",
                 ckpt_dir: Optional[str] = None, ckpt_keep: int = 3,
                 max_queue: Optional[int] = None, guard: bool = True,
                 guard_limit: float = 1e6,
                 ckpt_every_rounds: Optional[int] = None,
                 max_round_retries: int = 2, retry_backoff_s: float = 0.05,
                 fault_injector=None, failover: bool = True,
                 round_deadline_s: Optional[float] = None):
        if slots < 1:
            raise ValueError(f"slots={slots} must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1 (or None "
                             f"for unbounded)")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh= wants a launch.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            first = mesh.device_list[0]
            if device is not None and torch.device(device).type != first.type:
                raise ValueError(f"device={device!r} but the mesh's devices "
                                 f"are {first.type}")
            device = first
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ForecastEngine(device='cuda'): no CUDA "
                               "device is available; pass device='cpu' to "
                               "run the plain PyTorch versions")
        self.slots = slots
        self.mesh = mesh
        self.mesh_axes = (ax_e, ax_y, ax_x)
        self.failover = failover
        self.device = device
        self.ckpt_dir = ckpt_dir
        self.ckpt_keep = ckpt_keep
        self.max_queue = max_queue
        self.guard = guard
        self.guard_limit = float(guard_limit)
        self.ckpt_every_rounds = ckpt_every_rounds
        self.max_round_retries = max_round_retries
        self.retry_backoff_s = retry_backoff_s
        self.fault_injector = fault_injector
        self.round_deadline_s = round_deadline_s

        self._queue: collections.deque[_Pending] = collections.deque()
        self._lanes: Dict[_wprog.StencilProgram, _Lane] = {}
        self._plans: Dict[_wprog.StencilProgram, _wprog.ExecutionPlan] = {}
        self._fallbacks: Dict[_wprog.StencilProgram, Dict[str, Any]] = {}
        # First-resolution (variant, k_steps) per program key: a lane's
        # canonical round sequence is fixed when its plan first compiles,
        # and a restore re-pins it.
        self._pinned: Dict[_wprog.StencilProgram, Dict[str, Any]] = {}
        self._failovers: List[Dict[str, Any]] = []
        self._results: Dict[int, ForecastResult] = {}
        self._next_rid = 0
        self._ckpt_step = 0
        self._last_ckpt_round = 0
        self._stats = {"plan_cache_hits": 0, "plan_cache_misses": 0,
                       "rounds": 0, "admitted": 0, "completed": 0,
                       "rolled_back_slot_rounds": 0,
                       "occupancy_sum": 0.0, "occupancy_samples": 0,
                       "quarantined": 0, "scrubbed_idle_slots": 0,
                       "round_retries": 0, "lane_failures": 0,
                       "fallback_compiles": 0, "rejected": 0,
                       "deadline_expired": 0, "watchdog_checkpoints": 0,
                       "mesh_failovers": 0, "recovery_rounds": 0,
                       "requests_preserved": 0, "fingerprint_divergence": 0,
                       "round_deadline_hits": 0, "plan_repins": 0}

    # -- public API ---------------------------------------------------------
    def submit(self, request: ForecastRequest) -> int:
        """Enqueue one forecast; returns its rid. The initial state is
        staged onto the device NOW (non-blocking from pinned memory), so
        admission later is a device-side copy.

        Raises `QueueFullError` when `max_queue` is set and the queue is
        at capacity."""
        request.validate()
        if (self.max_queue is not None
                and len(self._queue) >= self.max_queue):
            self._stats["rejected"] += 1
            raise QueueFullError(
                f"queue is full ({len(self._queue)}/{self.max_queue} "
                f"pending, slots={self.slots}): the engine is saturated — "
                f"retry after a pump()/drain(), shed load upstream, or "
                f"raise max_queue")
        if request.rid is None:
            request.rid = self._next_rid
        self._next_rid = max(self._next_rid, request.rid) + 1
        request.state = _stage(request.state, self.device)
        self._queue.append(_Pending(request, time.perf_counter()))
        return request.rid

    def has_work(self) -> bool:
        return bool(self._queue) or any(
            any(s is not None for s in lane.slots)
            for lane in self._lanes.values())

    def pump(self) -> bool:
        """Admit whatever fits, advance every busy lane ONE round, retire
        finished slots. Returns `has_work()`. With `ckpt_every_rounds` set
        (and a ckpt_dir), the watchdog checkpoints at the pump boundary,
        where every lane sits at a round boundary."""
        self._admit()
        for lane in self._lanes.values():
            if any(s is not None for s in lane.slots):
                self._round(lane)
        if (self.ckpt_every_rounds and self.ckpt_dir is not None
                and self._stats["rounds"] - self._last_ckpt_round
                >= self.ckpt_every_rounds):
            self.checkpoint()
            self._last_ckpt_round = self._stats["rounds"]
            self._stats["watchdog_checkpoints"] += 1
        return self.has_work()

    def drain(self) -> Dict[int, ForecastResult]:
        """Pump until idle; returns ALL results finished so far."""
        while self.pump():
            pass
        return dict(self._results)

    @property
    def results(self) -> Dict[int, ForecastResult]:
        return dict(self._results)

    def stats(self) -> Dict[str, Any]:
        """Service counters under the JAX package's keys: plan-cache hit
        rate, mean occupancy, rounds, supervision counters, each mesh
        failover (`failovers`) and the mesh's logical device ids
        (`mesh_devices`, None on one device)."""
        s = dict(self._stats)
        lookups = s["plan_cache_hits"] + s["plan_cache_misses"]
        s["plan_cache_hit_rate"] = (
            s["plan_cache_hits"] / lookups if lookups else None)
        s["occupancy"] = (s["occupancy_sum"] / s["occupancy_samples"]
                          if s["occupancy_samples"] else 0.0)
        s["plans_cached"] = len(self._plans)
        s["queued"] = len(self._queue)
        s["active"] = sum(sum(sl is not None for sl in lane.slots)
                          for lane in self._lanes.values())
        s["failed"] = sum(1 for r in self._results.values()
                          if r.status == "failed")
        s["expired"] = sum(1 for r in self._results.values()
                           if r.status == "expired")
        s["plan_fallbacks"] = {k.op: v["stage"]
                               for k, v in self._fallbacks.items()}
        s["failovers"] = [dict(f) for f in self._failovers]
        s["mesh_devices"] = self._device_ids()
        return s

    # -- scheduling ---------------------------------------------------------
    def _where(self) -> Dict[str, Any]:
        """`compile`'s placement arguments: the device, or the mesh and its
        axes."""
        if self.mesh is None:
            return {"device": self.device}
        ax_e, ax_y, ax_x = self.mesh_axes
        return {"mesh": self.mesh, "ax_e": ax_e, "ax_y": ax_y, "ax_x": ax_x}

    def _plan_for(self, key: _wprog.StencilProgram) -> _wprog.ExecutionPlan:
        plan = self._plans.get(key)
        if plan is None:
            inj = self.fault_injector
            prog = key
            pinned = self._pinned.get(key)
            if pinned is not None:
                # Recompiling an already-served program (a failover or an
                # elastic restore): pin the FIRST resolution's round
                # strategy so in-flight canonical round sequences stay
                # intact; if it cannot compile here, re-resolve and count it.
                prog = dataclasses.replace(key, variant=pinned["variant"],
                                           k_steps=pinned["k_steps"])
                try:
                    _wprog.compile(prog, **self._where())
                except Exception:  # noqa: BLE001 — planner rejection
                    self._stats["plan_repins"] += 1
                    prog = key
            # Through the module, so a spy on
            # repro_torch.weather.program.compile sees every compile.
            plan, fallback, errors = _wprog.compile_with_fallback(
                prog, **self._where(),
                attempt_hook=inj.on_compile if inj is not None else None)
            if fallback is not None:
                self._stats["fallback_compiles"] += 1
                self._fallbacks[key] = {"stage": fallback, "errors": errors}
            self._plans[key] = plan
            self._pinned.setdefault(
                key, {"variant": plan.variant, "k_steps": plan.k_steps})
        return plan

    def _zeros(self, key: _wprog.StencilProgram):
        """A zero lane batch: on the device, or made on each shard of the
        mesh by the plan's `state_spec`."""
        if self.mesh is not None:
            return _domain.zeros_sharded(
                key.grid_shape, self.slots, key.dtype, key.fields, self.mesh,
                self._plan_for(key).state_spec)
        return _fields.zeros_state(key.grid_shape, ensemble=self.slots,
                                   dtype=key.dtype, names=key.fields,
                                   device=self.device)

    def _lane_for(self, key: _wprog.StencilProgram) -> _Lane:
        lane = self._lanes.get(key)
        if lane is None:
            lane = _Lane(key=key, batch=self._zeros(key),
                         slots=[None] * self.slots)
            self._lanes[key] = lane
        return lane

    def _admit(self) -> None:
        """FIFO admission: fill free slots per lane; a lane with no free
        slot does not block requests bound for other lanes. Each admitted
        request is one in-place copy into its slot (on a mesh, of each
        shard's block into that shard's lane)."""
        now = time.perf_counter()
        waves: Dict[_wprog.StencilProgram,
                    List[Tuple[int, _Pending]]] = {}
        keep: collections.deque[_Pending] = collections.deque()
        free: Dict[_wprog.StencilProgram, List[int]] = {}
        for pend in self._queue:
            req = pend.request
            if (req.deadline_s is not None
                    and now - pend.submit_t > req.deadline_s):
                # Expired while queued: serving it now would waste a slot.
                self._stats["deadline_expired"] += 1
                self._finish(req.rid, req.program, _host(req.state),
                             steps=req.steps, admit_t=now,
                             queue_wait_s=now - pend.submit_t, rounds=0,
                             status="expired", steps_done=0,
                             diagnosis={"reason": "deadline_exceeded",
                                        "deadline_s": req.deadline_s,
                                        "waited_s": now - pend.submit_t,
                                        "where": "queue"})
                continue
            if req.steps == 0:
                # A 0-step forecast is its own answer (solo run(state, 0)
                # is the identity) — finish without occupying a slot.
                self._finish(req.rid, req.program, _host(req.state),
                             steps=0, admit_t=now,
                             queue_wait_s=now - pend.submit_t, rounds=0)
                continue
            key = _wprog.plan_cache_key(req.program, ensemble=self.slots)
            # Request-level cache accounting (once per request): N requests
            # over M programs miss exactly M times.
            if not pend.counted:
                pend.counted = True
                if key in self._plans:
                    self._stats["plan_cache_hits"] += 1
                else:
                    self._stats["plan_cache_misses"] += 1
                    self._plan_for(key)
            lane = self._lane_for(key)
            if key not in free:
                free[key] = [i for i, s in enumerate(lane.slots)
                             if s is None]
            if free[key]:
                waves.setdefault(key, []).append((free[key].pop(0), pend))
            else:
                keep.append(pend)
        self._queue = keep
        for key, wave in waves.items():
            lane = self._lanes[key]
            for i, pend in wave:
                _wprog.ensemble_slot_assign(lane.batch, [i],
                                            pend.request.state)
            admit_t = time.perf_counter()
            for i, pend in wave:
                lane.fps.pop(i, None)   # fresh content in this slot
                req = pend.request
                lane.slots[i] = _Slot(rid=req.rid, remaining=req.steps,
                                      steps=req.steps, admit_t=admit_t,
                                      queue_wait_s=admit_t - pend.submit_t,
                                      deadline_s=req.deadline_s)
                self._stats["admitted"] += 1

    def _round(self, lane: _Lane) -> None:
        """One SUPERVISED lane round: the shortest next canonical part
        among active slots picks the round depth; slots whose next part is
        deeper run along and are rolled back (uncredited). Around that, the
        step retries with backoff (then fails only this lane's requests),
        the fault injector's poison hook fires post-step, the guard
        quarantines invalid slots before credit, and per-request deadlines
        expire at the boundary."""
        plan = self._plan_for(lane.key)
        k = plan.k_steps
        parts = {i: min(s.remaining, k)
                 for i, s in enumerate(lane.slots) if s is not None}
        kk = min(parts.values())
        participants = [i for i, p in parts.items() if p == kk]
        rnd = self._stats["rounds"]
        # the step (on a mesh, every shard's) writes new tensors and never
        # its input, so `prev` keeps the pre-round bits for the in-place
        # rollback, and a failed round leaves the batch at the last round
        # boundary (the failover's pivot)
        prev = lane.batch if len(participants) < len(parts) else None
        new_batch = self._step_with_retry(lane, plan, kk, rnd)
        if new_batch is None:                    # escalation exhausted
            if self._try_failover(lane, rnd):
                return          # the round re-ran on the rebuilt mesh
            self._fail_lane(lane, rnd)
            return
        lane.batch = new_batch
        if prev is not None:
            mask = np.zeros(self.slots, bool)
            mask[participants] = True
            lane.batch = _wprog.ensemble_slot_select(mask, lane.batch, prev)
            self._stats["rolled_back_slot_rounds"] += (
                len(parts) - len(participants))
        self._stats["rounds"] += 1
        self._stats["occupancy_sum"] += len(parts) / self.slots
        self._stats["occupancy_samples"] += 1
        inj = self.fault_injector
        if inj is not None:
            nonparts = tuple(i for i in range(self.slots)
                             if i not in set(participants))
            lane.batch = inj.poison(lane.batch, lane.key.op, rnd,
                                    tuple(parts), nonparticipants=nonparts,
                                    shards=plan.shards)
        bad = (self._guard_check(lane, parts, participants, rnd)
               if self.guard else {})
        for i, (diag, state) in bad.items():
            self._quarantine(lane, i, diag, state)
        for i in participants:
            if i in bad:
                continue
            slot = lane.slots[i]
            slot.remaining -= kk
            slot.rounds += 1
            if slot.remaining == 0:
                self._retire(lane, i)
        now = time.perf_counter()
        for i, slot in enumerate(lane.slots):
            if (slot is not None and slot.deadline_s is not None
                    and now - slot.submit_t > slot.deadline_s):
                self._expire_slot(lane, i, now)

    def _sync(self) -> None:
        devices = ([self.device] if self.mesh is None
                   else self.mesh.device_list)
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _step_with_retry(self, lane: _Lane, plan, kk: int, rnd: int):
        """Run one round, retrying failures with exponential backoff.
        Returns the new batch, or None once `max_round_retries` retries
        failed (the port has no interpreter to degrade to; the caller fails
        over or fails the lane). With `round_deadline_s` set, an attempt
        whose wall clock exceeds it counts as a failed attempt."""
        inj = self.fault_injector
        delay = self.retry_backoff_s
        last = None
        for attempt in range(self.max_round_retries + 1):
            try:
                t0 = time.perf_counter()
                if inj is not None:
                    inj.on_round(lane.key.op, rnd,
                                 device_ids=self._device_ids())
                out = plan.round_plan(kk).step(lane.batch)
                if (self.guard or inj is not None
                        or self.round_deadline_s is not None):
                    # surface asynchronous failures here, inside the retry
                    # scope (the guard reads the batch right after anyway)
                    self._sync()
                if (self.round_deadline_s is not None
                        and time.perf_counter() - t0
                        > self.round_deadline_s):
                    self._stats["round_deadline_hits"] += 1
                    raise RoundDeadlineError(
                        f"round {rnd} attempt took "
                        f"{time.perf_counter() - t0:.3f}s > "
                        f"round_deadline_s={self.round_deadline_s}")
                return out
            except Exception as e:  # noqa: BLE001 — supervised boundary
                self._stats["round_retries"] += 1
                last = e
                if attempt < self.max_round_retries:
                    time.sleep(delay)
                    delay *= 2
        self._last_round_error = repr(last)
        self._last_round_exc = last
        return None

    def _fail_lane(self, lane: _Lane, rnd: int) -> None:
        """A round failed beyond retry (and failover): fail ONLY this
        lane's in-flight requests (each with a diagnosis and its pre-round
        state) and reset the lane (re-zeroed, on a mesh resharded), so the
        rest of the engine keeps serving."""
        self._stats["lane_failures"] += 1
        err = getattr(self, "_last_round_error", "unknown")
        for i, slot in enumerate(lane.slots):
            if slot is None:
                continue
            lane.slots[i] = None
            state = self._slot_host(lane, i)
            self._finish(slot.rid,
                         dataclasses.replace(lane.key, ensemble=1), state,
                         steps=slot.steps, admit_t=slot.admit_t,
                         queue_wait_s=slot.queue_wait_s, rounds=slot.rounds,
                         status="failed",
                         steps_done=slot.steps - slot.remaining,
                         diagnosis={"reason": "round_failure", "round": rnd,
                                    "error": err})
        lane.batch = self._zeros(lane.key)
        lane.fps.clear()

    # -- mesh failover ------------------------------------------------------
    def _device_ids(self) -> Optional[List[int]]:
        """The mesh's logical device ids (None on one device)."""
        return None if self.mesh is None else list(self.mesh.ids)

    @staticmethod
    def _probe_devices(devices) -> List[Tuple[int, torch.device]]:
        """The `(id, device)` pairs among `devices` that still answer a
        tiny transfer, add and readback (the failure-agnostic way to find
        survivors when the round's error named no device)."""
        alive = []
        for i, dev in devices:
            try:
                float((torch.zeros((), device=dev) + 1).cpu())
                alive.append((i, dev))
            except Exception:  # noqa: BLE001 — that IS the probe's result
                pass
        return alive

    def _try_failover(self, lane: _Lane, rnd: int) -> bool:
        """Past retry: rebuild the mesh from the surviving devices and
        resume EVERY in-flight request from the last round boundary.
        Returns True when the interrupted round re-ran on the new mesh,
        False when failover is off, no device is identifiably lost, or no
        surviving shape carries the lanes (the caller then fails the lane).

        The lost device is the round error's `lost_device`, else what a
        probe of each logical device finds dead. Every lane's pre-round
        batch is gathered (the pivot: nothing was credited and the round
        wrote nothing into it); `domain.failover_meshes` over the
        survivors, of the mesh's own kind, is walked best first until every
        lane's plan compiles (with its pinned round strategy); the lanes are
        resharded and the round re-runs. Digests are sharding-invariant and
        keep guarding across the change."""
        if not self.failover or self.mesh is None:
            return False
        ids, devs = list(self.mesh.ids), self.mesh.device_list
        lost = getattr(getattr(self, "_last_round_exc", None),
                       "lost_device", None)
        if lost is not None:
            survivors = [(i, d) for i, d in zip(ids, devs) if i != int(lost)]
        else:
            survivors = self._probe_devices(zip(ids, devs))
        if not survivors or len(survivors) == len(devs):
            return False        # nothing identifiably lost: not a mesh fault
        t0 = time.perf_counter()
        host = {key: _domain.gather_state(ln.batch)
                for key, ln in self._lanes.items()}
        old = (self.mesh, self._plans, self._fallbacks)
        like = (self._plans[lane.key].shards if lane.key in self._plans
                else None)
        _, ax_y, ax_x = self.mesh_axes
        grids = [ln.key.grid_shape for ln in self._lanes.values()]
        chosen = None
        for mesh2 in _domain.failover_meshes(
                [d for _, d in survivors], grids, axes=(ax_y, ax_x),
                like=like, ids=[i for i, _ in survivors]):
            self.mesh, self._plans, self._fallbacks = mesh2, {}, {}
            try:
                for key in self._lanes:
                    self._plan_for(key)
                chosen = mesh2
                break
            except Exception:  # noqa: BLE001 — try the next shape
                continue
        if chosen is None:
            self.mesh, self._plans, self._fallbacks = old
            return False
        for key, ln in self._lanes.items():
            ln.batch = _domain.shard_state(host[key], self.mesh,
                                           self._plan_for(key).state_spec)
        self._sync()
        active = sum(sum(s is not None for s in ln.slots)
                     for ln in self._lanes.values())
        self._stats["mesh_failovers"] += 1
        self._stats["recovery_rounds"] += 1
        self._stats["requests_preserved"] += active
        self._failovers.append({
            "round": rnd,
            "lost_device": None if lost is None else int(lost),
            "from_devices": list(ids),
            "to_devices": list(self.mesh.ids),
            "from_shape": None if like is None else list(like),
            "to_shape": list(self._plan_for(lane.key).shards),
            "reshard_ms": (time.perf_counter() - t0) * 1e3,
            "requests_preserved": active,
        })
        self._round(lane)       # re-run the interrupted round
        return True

    # -- validity guard / quarantine ---------------------------------------
    def _guard_check(self, lane: _Lane, parts: Dict[int, int],
                     participants: List[int],
                     rnd: int) -> Dict[int, Tuple[Dict[str, Any],
                                                  WeatherState]]:
        """The per-slot supervision pass over the lane batch at the round
        boundary (`program.slot_guard`: one launch; on a mesh a partial
        launch a distinct block and one combine) giving each slot a
        validity bit and a content digest. Active invalid slots are diagnosed
        (host readback of that slot); idle slots that rot are scrubbed to
        zeros. Slots that did NOT advance this round — rolled back or idle
        — must keep their digest bit for bit; a divergent in-flight slot
        quarantines, a divergent idle slot is scrubbed. Healthy slots are
        only read."""
        ok_d, fp_d = _wprog.slot_guard(lane.batch, self.guard_limit)
        ok, fp = ok_d.tolist(), fp_d.tolist()
        bad: Dict[int, Tuple[Dict[str, Any], WeatherState]] = {}
        for i in parts:
            if not ok[i]:
                bad[i] = self._diagnose(lane, i, rnd)
        for i, slot in enumerate(lane.slots):
            if slot is None and not ok[i]:
                self._scrub(lane, i)
                self._stats["scrubbed_idle_slots"] += 1
        advanced = set(participants)
        for i in range(self.slots):
            if i in bad or not ok[i]:
                continue        # already handled by the validity pass
            got = int(fp[i])
            if i in advanced or i not in lane.fps:
                # new bits (it advanced a round) or no digest yet: record
                lane.fps[i] = got
                continue
            want = lane.fps[i]
            if want == got:
                continue
            self._stats["fingerprint_divergence"] += 1
            if lane.slots[i] is not None:
                bad[i] = self._diagnose_fp(lane, i, rnd, want, got)
            else:
                self._scrub(lane, i)
                self._stats["scrubbed_idle_slots"] += 1
        return bad

    def _diagnose_fp(self, lane: _Lane, i: int, rnd: int, want: int,
                     got: int) -> Tuple[Dict[str, Any], WeatherState]:
        state = self._slot_host(lane, i)
        diag = {"reason": "fingerprint_divergence", "round": rnd,
                "expected_fp": want, "observed_fp": got,
                "note": "slot did not advance this round but its bits "
                        "changed: cross-shard/device divergence (e.g. a "
                        "corrupted halo wire buffer), invisible to "
                        "NaN/magnitude validity checks"}
        return diag, state

    def _diagnose(self, lane: _Lane, i: int,
                  rnd: int) -> Tuple[Dict[str, Any], WeatherState]:
        """Host-side diagnosis of one invalid slot (the slow path: it only
        runs on quarantine): per-leaf NaN/Inf/out-of-bounds counts."""
        state = self._slot_host(lane, i)
        leaves = {}
        for name, a in sorted(state.fields.items()):
            leaves[f"fields/{name}"] = a
        leaves["wcon"] = state.wcon
        for name, a in sorted(state.tens.items()):
            leaves[f"tens/{name}"] = a
        for name, a in sorted(state.stage_tens.items()):
            leaves[f"stage_tens/{name}"] = a
        per_leaf = {}
        for key, a in leaves.items():
            a = a.double()
            nan = int(torch.isnan(a).sum())
            inf = int(torch.isinf(a).sum())
            finite = a[torch.isfinite(a)]
            oob = int((finite.abs() > self.guard_limit).sum())
            if nan or inf or oob:
                per_leaf[key] = {"nan": nan, "inf": inf,
                                 "out_of_bounds": oob}
        diag = {"reason": "validity_guard", "round": rnd,
                "limit": self.guard_limit, "bad_leaves": per_leaf,
                "first_bad": next(iter(per_leaf), None)}
        return diag, state

    def _quarantine(self, lane: _Lane, i: int, diag: Dict[str, Any],
                    state: WeatherState) -> None:
        """Remove ONE offending slot: its request finishes `failed` with
        the diagnosis (and the offending state), the slot is re-zeroed and
        backfills from the queue at the next admit."""
        slot = lane.slots[i]
        lane.slots[i] = None
        self._stats["quarantined"] += 1
        self._scrub(lane, i)
        self._finish(slot.rid, dataclasses.replace(lane.key, ensemble=1),
                     state, steps=slot.steps, admit_t=slot.admit_t,
                     queue_wait_s=slot.queue_wait_s, rounds=slot.rounds,
                     status="failed",
                     steps_done=slot.steps - slot.remaining, diagnosis=diag)

    def _scrub(self, lane: _Lane, i: int) -> None:
        """Zero slot `i` in place (zeros are a fixed point of the
        stencils); on a mesh, in every shard that holds it."""
        zero = lambda t: t.zero_()
        if isinstance(lane.batch, _domain.ShardedState):
            for s, local in _domain.slot_shards(lane.batch, i):
                _wprog.map_state(_wprog.ensemble_slot_view(
                    lane.batch.shards[s], local), zero)
        else:
            _wprog.map_state(_wprog.ensemble_slot_view(lane.batch, i), zero)
        lane.fps.pop(i, None)   # the slot's bits were legitimately replaced

    @staticmethod
    def _slot_host(lane: _Lane, i: int) -> WeatherState:
        """Slot `i` of the lane as CPU tensors sharing nothing with it (on
        a mesh, gathered from the shards that hold it)."""
        if isinstance(lane.batch, _domain.ShardedState):
            return _wprog.ensemble_slot_view(lane.batch, i)
        return _host(_wprog.ensemble_slot_view(lane.batch, i))

    def _expire_slot(self, lane: _Lane, i: int, now: float) -> None:
        slot = lane.slots[i]
        lane.slots[i] = None
        self._stats["deadline_expired"] += 1
        state = self._slot_host(lane, i)
        self._scrub(lane, i)
        self._finish(slot.rid, dataclasses.replace(lane.key, ensemble=1),
                     state, steps=slot.steps, admit_t=slot.admit_t,
                     queue_wait_s=slot.queue_wait_s, rounds=slot.rounds,
                     status="expired",
                     steps_done=slot.steps - slot.remaining,
                     diagnosis={"reason": "deadline_exceeded",
                                "deadline_s": slot.deadline_s,
                                "elapsed_s": now - slot.submit_t,
                                "where": "in_flight"})

    def _retire(self, lane: _Lane, i: int) -> None:
        slot = lane.slots[i]
        lane.slots[i] = None
        # Read back exactly this slot; waiting here IS the finish time.
        state = self._slot_host(lane, i)
        # then zero it, so an idle slot holds the fixed point its digest
        # check expects (not counted as a scrub)
        self._scrub(lane, i)
        prog = dataclasses.replace(lane.key, ensemble=1)
        self._finish(slot.rid, prog, state, steps=slot.steps,
                     admit_t=slot.admit_t, queue_wait_s=slot.queue_wait_s,
                     rounds=slot.rounds)

    def _finish(self, rid: int, prog, state, *, steps: int, admit_t: float,
                queue_wait_s: float, rounds: int, status: str = "ok",
                steps_done: Optional[int] = None,
                diagnosis: Optional[Dict[str, Any]] = None) -> None:
        self._results[rid] = ForecastResult(
            rid=rid, program=prog, state=state, steps=steps,
            latency_s=time.perf_counter() - admit_t,
            queue_wait_s=queue_wait_s, rounds=rounds, status=status,
            steps_done=steps if steps_done is None else steps_done,
            diagnosis=diagnosis)
        self._stats["completed"] += 1

    # -- warm-state checkpointing ------------------------------------------
    def checkpoint(self, ckpt_dir: Optional[str] = None,
                   step: Optional[int] = None) -> int:
        """Persist the warm engine (in-flight batches, queue, results,
        bookkeeping) atomically via `ckpt.save_tree`, in the JAX package's
        layout. Returns the checkpoint step. In-flight latency clocks are
        stored as elapsed-so-far and resume ticking on restore."""
        ckpt_dir = ckpt_dir or self.ckpt_dir
        if ckpt_dir is None:
            raise ValueError("no ckpt_dir: pass one here or at __init__")
        if step is None:
            step = self._ckpt_step
        self._ckpt_step = step + 1
        now = time.perf_counter()
        lanes = list(self._lanes.values())
        tree = {
            # a sharded lane is persisted whole (unsharded-logical), so a
            # checkpoint restores onto any device or mesh
            "lanes": [_domain.gather_state(lane.batch)
                      if isinstance(lane.batch, _domain.ShardedState)
                      else lane.batch for lane in lanes],
            "queue": [p.request.state for p in self._queue],
            "results": {str(rid): r.state
                        for rid, r in self._results.items()},
        }
        extra = {
            "slots": self.slots,
            "next_rid": self._next_rid,
            "ckpt_step": self._ckpt_step,
            "stats": {k: v for k, v in self._stats.items()},
            "mesh_devices": None if self.mesh is None else self.mesh.size,
            "config": {
                "max_queue": self.max_queue, "guard": self.guard,
                "guard_limit": self.guard_limit,
                "ckpt_every_rounds": self.ckpt_every_rounds,
                "max_round_retries": self.max_round_retries,
                "retry_backoff_s": self.retry_backoff_s,
                "last_ckpt_round": self._last_ckpt_round,
            },
            "lanes": [{
                "program": lane.key.to_json(),
                # the resolved round strategy: restore re-pins it
                "plan": self._pinned.get(lane.key),
                "slots": [None if s is None else {
                    "rid": s.rid, "remaining": s.remaining,
                    "steps": s.steps, "rounds": s.rounds,
                    "elapsed_s": now - s.admit_t,
                    "queue_wait_s": s.queue_wait_s,
                    "deadline_s": s.deadline_s,
                } for s in lane.slots],
            } for lane in lanes],
            "queue": [{
                "rid": p.request.rid,
                "steps": p.request.steps,
                "program": p.request.program.to_json(),
                "waited_s": now - p.submit_t,
                "deadline_s": p.request.deadline_s,
            } for p in self._queue],
            "results": [{
                "rid": r.rid, "steps": r.steps, "rounds": r.rounds,
                "latency_s": r.latency_s, "queue_wait_s": r.queue_wait_s,
                "program": r.program.to_json(),
                "status": r.status, "steps_done": r.steps_done,
                "diagnosis": r.diagnosis,
            } for r in self._results.values()],
        }
        ckpt.save_tree(ckpt_dir, step, tree, extra=extra,
                       keep=self.ckpt_keep)
        return step

    @classmethod
    def restore(cls, ckpt_dir: str, step: Optional[int] = None, *,
                mesh: Optional[Mesh] = None, device=None,
                ax_e: Optional[str] = "pod", ax_y: str = "data",
                ax_x: str = "model", ckpt_keep: int = 3,
                fault_injector=None) -> "ForecastEngine":
        """Resume a checkpointed engine (either package's, written on any
        device or mesh) on `device`, or on `mesh` over `ax_*`.

        In-flight forecasts continue from their persisted round boundary,
        queued requests stay queued, finished results are preserved; plans
        recompile through the plan cache with the persisted (variant,
        k_steps) pin, and on a mesh each lane is resharded through its new
        plan's `state_spec` (the pin seeded first); the supervision config
        comes from the checkpoint.
        With `step=None` the newest checkpoint is used; when it is corrupt
        (`ckpt.CheckpointCorruptError`), restore falls back to the
        next-older valid one, and raises an aggregated error only when
        every retained checkpoint is unreadable."""
        kw = dict(mesh=mesh, device=device, ax_e=ax_e, ax_y=ax_y, ax_x=ax_x,
                  ckpt_keep=ckpt_keep, fault_injector=fault_injector)
        if step is not None:
            return cls._restore_step(ckpt_dir, step, **kw)
        steps = sorted(ckpt.all_steps(ckpt_dir), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir!r}")
        failures = []
        for s in steps:
            try:
                return cls._restore_step(ckpt_dir, s, **kw)
            except ckpt.CheckpointCorruptError as e:
                failures.append((s, e))
        raise ckpt.CheckpointCorruptError(
            f"every checkpoint in {ckpt_dir!r} is unreadable — "
            + "; ".join(f"step {s}: {e}" for s, e in failures))

    @classmethod
    def _restore_step(cls, ckpt_dir: str, step: int, *, mesh, device, ax_e,
                      ax_y, ax_x, ckpt_keep: int,
                      fault_injector) -> "ForecastEngine":
        def prog_of(d):
            return _wprog.StencilProgram.from_json(d)

        def template(prog, ensemble):
            # structure and dtypes only: meta tensors hold no memory
            return _fields.zeros_state(prog.grid_shape, ensemble=ensemble,
                                       dtype=prog.dtype, names=prog.fields,
                                       device="meta")

        meta = ckpt.read_meta(ckpt_dir, step)
        try:
            extra = meta["extra"]
            slots = extra["slots"]
            tmpl = {
                "lanes": [template(prog_of(ln["program"]), slots)
                          for ln in extra["lanes"]],
                "queue": [template(prog_of(q["program"]), 1)
                          for q in extra["queue"]],
                "results": {str(r["rid"]): template(prog_of(r["program"]), 1)
                            for r in extra["results"]},
            }
        except (KeyError, TypeError) as e:
            raise ckpt.CheckpointCorruptError(
                f"checkpoint {ckpt_dir!r} step {step}: the engine sidecar "
                f"is missing or malformed at {e!r} — written by an "
                f"incompatible engine version or truncated. Restore from "
                f"another step, or re-checkpoint with this engine."
            ) from e
        tree, _ = ckpt.restore_tree(ckpt_dir, step, tmpl, device="cpu")

        cfg = extra.get("config", {})
        eng = cls(slots=slots, mesh=mesh, device=device, ax_e=ax_e,
                  ax_y=ax_y, ax_x=ax_x, ckpt_dir=ckpt_dir,
                  ckpt_keep=ckpt_keep,
                  max_queue=cfg.get("max_queue"),
                  guard=cfg.get("guard", True),
                  guard_limit=cfg.get("guard_limit", 1e6),
                  ckpt_every_rounds=cfg.get("ckpt_every_rounds"),
                  max_round_retries=cfg.get("max_round_retries", 2),
                  retry_backoff_s=cfg.get("retry_backoff_s", 0.05),
                  fault_injector=fault_injector)
        eng._next_rid = extra["next_rid"]
        eng._ckpt_step = extra["ckpt_step"]
        eng._last_ckpt_round = cfg.get("last_ckpt_round", 0)
        eng._stats.update(extra["stats"])
        now = time.perf_counter()
        for ln, batch in zip(extra["lanes"], tree["lanes"]):
            key = _wprog.plan_cache_key(prog_of(ln["program"]),
                                        ensemble=slots)
            pin = ln.get("plan")
            if pin is not None:
                # seed the round-strategy pin BEFORE the first compile
                eng._pinned[key] = dict(pin)
            if mesh is not None:
                batch = _domain.shard_state(batch, mesh,
                                            eng._plan_for(key).state_spec)
            else:
                batch = _stage(batch, eng.device)
            eng._lanes[key] = _Lane(
                key=key, batch=batch,
                slots=[None if s is None else _Slot(
                    rid=s["rid"], remaining=s["remaining"],
                    steps=s["steps"], rounds=s["rounds"],
                    admit_t=now - s["elapsed_s"],
                    queue_wait_s=s["queue_wait_s"],
                    deadline_s=s.get("deadline_s"))
                    for s in ln["slots"]])
        for q, state in zip(extra["queue"], tree["queue"]):
            req = ForecastRequest(program=prog_of(q["program"]),
                                  state=_stage(state, eng.device),
                                  steps=q["steps"], rid=q["rid"],
                                  deadline_s=q.get("deadline_s"))
            eng._queue.append(_Pending(req, now - q["waited_s"]))
        for r in extra["results"]:
            eng._results[r["rid"]] = ForecastResult(
                rid=r["rid"], program=prog_of(r["program"]),
                state=tree["results"][str(r["rid"])],
                steps=r["steps"], latency_s=r["latency_s"],
                queue_wait_s=r["queue_wait_s"], rounds=r["rounds"],
                status=r.get("status", "ok"),
                steps_done=r.get("steps_done", r["steps"]),
                diagnosis=r.get("diagnosis"))
        return eng
