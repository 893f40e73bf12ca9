"""Multi-objective tile auto-tuner: the paper's OpenTuner stage.

A port of `repro.core.autotune`. NERO selects its window by
multi-objective optimization (performance against FPGA resource use) and
shows the Pareto optimum shifting with precision (paper Fig. 6). Here the
objectives are (predicted or measured time, near-memory bytes); the search
is exhaustive over the legal tile space, which near-memory capacity keeps
small. Also here:

* `plan_k_steps` / `resolve_k_steps`, the communication-avoiding depth of
  a distributed round from `core/memmodel.py`'s exchange model; a k is
  legal when the CUDA kernel takes it (`tiling.dycore_kstep_tile` on the
  padded local slab), not when it fits a TPU's VMEM. On one device
  `compile` resolves `k_steps="auto"` to 1 and does not call them;
* `measure_walltime` and the disk cache of `compile(tune="measure")`: a
  measured pick is stored under `$REPRO_TUNE_CACHE` (default
  `~/.cache/repro_torch/tune`, apart from the JAX package's), keyed on
  the program, the spec's fingerprint and the device (`backend_name`), so
  a pick measured on the CPU is never replayed on the card, nor the
  reverse.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import hierarchy as hw
from repro_torch.core import hwspec
from repro_torch.core import memmodel
from repro_torch.core import perfmodel
from repro_torch.core import tiling as _tiling
from repro_torch.core.tiling import OpSpec, TilePlan, candidate_tiles


@dataclasses.dataclass(frozen=True)
class TunedResult:
    plan: TilePlan
    est: perfmodel.PerfEstimate
    pareto: Tuple[Tuple[float, int], ...]   # (time_s, vmem_bytes) frontier


# Registry of tunable op tile spaces, name -> OpSpec.
OP_SPECS = {
    spec.name: spec
    for spec in (_tiling.HDIFF, _tiling.VADVC, _tiling.COPY,
                 _tiling.LRU_SCAN, _tiling.DYCORE_FUSED,
                 _tiling.DYCORE_WHOLE_STATE, _tiling.DYCORE_KSTEP,
                 _tiling.HADV_UPWIND, _tiling.VADVC_UPDATE,
                 _tiling.ASSELIN)
}


def register_op(spec: OpSpec) -> OpSpec:
    """Add (or replace) an op's tile space in the registry."""
    OP_SPECS[spec.name] = spec
    return spec


def get_op(name: str) -> OpSpec:
    try:
        return OP_SPECS[name]
    except KeyError:
        raise KeyError(f"unknown op {name!r}; registered: "
                       f"{sorted(OP_SPECS)}") from None


def tune_named(name: str, grid_shape: Sequence[int], dtype,
               **kwargs) -> "TunedResult":
    """`tune` with the OpSpec looked up by registered name."""
    return tune(get_op(name), grid_shape, dtype, **kwargs)


def pareto_front(points: Sequence[Tuple[float, int, int]]) -> List[int]:
    """Indices of the Pareto-optimal (time, vmem) points (minimize both)."""
    idx = sorted(range(len(points)), key=lambda i: (points[i][0], points[i][1]))
    front, best_mem = [], None
    for i in idx:
        mem = points[i][1]
        if best_mem is None or mem < best_mem:
            front.append(i)
            best_mem = mem
    return front


def tune(op: OpSpec,
         grid_shape: Sequence[int],
         dtype,
         hier: Optional[hw.Hierarchy] = None,
         chips: int = 1,
         measure: Optional[Callable[[TilePlan], float]] = None,
         vmem_weight: float = 0.0,
         spec: Optional[hwspec.HardwareSpec] = None) -> TunedResult:
    """Pick the tile plan.

    `measure`, when given, is a wall-clock callable (seconds; `math.inf`
    for a candidate the kernel cannot run) used instead of the analytic
    model: the paper's "auto-tuned" mode; the analytic default is its
    "model-guided" mode. `spec` selects the machine modelled (candidate
    pruning uses its hierarchy, scoring its kernel classes); without one,
    `hwspec.default_spec()`. `vmem_weight` trades resources for speed (0:
    pure performance, the paper's red-circled Pareto picks)."""
    if hier is None:
        hier = (spec or hwspec.default_spec()).hierarchy()
    cands = candidate_tiles(op, grid_shape, dtype, hier)
    if not cands:
        raise ValueError(
            f"no legal tile for op={op.name} grid={grid_shape} dtype={dtype}")

    scored: List[Tuple[float, int, int]] = []
    ests: List[perfmodel.PerfEstimate] = []
    for i, plan in enumerate(cands):
        est = perfmodel.estimate(plan, hier, chips=chips, spec=spec)
        t = measure(plan) if measure is not None else est.time_s
        scored.append((t, plan.vmem_bytes, i))
        ests.append(est)

    front = pareto_front(scored)

    def cost(i: int) -> float:
        t, mem, _ = scored[i]
        return t * (1.0 + vmem_weight * mem / hier.vmem.capacity_bytes)
    best = min(front, key=cost)
    frontier = tuple((scored[i][0], scored[i][1]) for i in front)
    return TunedResult(plan=cands[best], est=ests[best], pareto=frontier)


def tuned_window(op: OpSpec, grid_shape: Sequence[int], dtype,
                 fallback: Tuple[int, int, int],
                 hier: Optional[hw.Hierarchy] = None) -> Tuple[int, int, int]:
    """The analytic model's pick of `op`'s window at the grid, tuned under
    `hwspec.default_spec()` (or within `hier`), as the JAX package's
    `kernels/*/ops.py::plan_tile` tune it; `fallback` where no window of
    the space fits that near memory (the dycore's whole z-by-x slabs never
    fit the H100's 227 KB of shared memory)."""
    try:
        return tune(op, grid_shape, dtype, hier=hier).plan.tile
    except ValueError:
        return tuple(fallback)


# ---------------------------------------------------------------------------
# k_steps: the communication-avoiding depth of a distributed round
# ---------------------------------------------------------------------------

# Fused dycore flops a point, field and step (tiling.DYCORE_FUSED).
_DYCORE_FLOPS_PER_POINT = _tiling.DYCORE_FUSED.flops_per_point


def plan_k_steps(grid_shape: Sequence[int], dtype, mesh_shape,
                 *, n_fields: int = 4, halo: int = 2, max_k: int = 8,
                 hier: Optional[hw.Hierarchy] = None,
                 latency_s: Optional[float] = None,
                 utilization: float = 0.85,
                 flops_per_point: Optional[float] = None,
                 exchange_model: Optional[Callable] = None,
                 spec: Optional[hwspec.HardwareSpec] = None) -> int:
    """The depth k of a distributed stencil round, the argmin over
    k = 1..max_k of the modelled cost a timestep:

        (rounds(k) * latency + wire_bytes(k) / link_bw) / k    collectives
      + compute * (1 + redundant_flops_frac(k))                halo-ring tax

    `exchange_model(k)` gives the `memmodel.packed_exchange_model` numbers
    at depth k (default: the fused dycore's `kstep_exchange_model`); the
    compute term is the op's `flops_per_point` over the local slab at the
    spec's peak. Candidates stop where the halo outgrows the local slab
    (the model raises ValueError). `mesh_shape` is (py, px); `spec`
    defaults to `hwspec.default_spec()`. The JAX package's arithmetic."""
    spec = spec or hwspec.default_spec()
    if hier is None:
        hier = spec.hierarchy()
    if latency_s is None:
        latency_s = spec.collective.latency_s
    nz, ny, nx = (int(g) for g in grid_shape)
    py, px = (int(s) for s in mesh_shape)
    ly, lx = ny // py, nx // px
    b = hw.dtype_bytes(dtype)
    peak = (hier.peak_flops_bf16 if b <= 2 else hier.peak_flops_fp32)
    if flops_per_point is None:
        flops_per_point = _DYCORE_FLOPS_PER_POINT
    if exchange_model is None:
        def exchange_model(k):
            return memmodel.kstep_exchange_model(
                grid_shape, dtype, n_fields=n_fields, k=k,
                shards=(py, px), halo=halo)
    compute_s = (flops_per_point * n_fields * nz * ly * lx
                 / (peak * utilization))

    best_k, best_cost = 1, None
    for k in range(1, max_k + 1):
        try:
            m = exchange_model(k)
        except ValueError:
            break   # the halo outgrew the local slab
        coll_s = (m["rounds_kstep"] * latency_s
                  + m["bytes_kstep"] / hier.ici_bw) / k
        cost = coll_s + compute_s * (1.0 + m["redundant_flops_frac"])
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


def dycore_kstep_check(grid_shape: Sequence[int], mesh_shape,
                       halo: int = 2) -> Callable[[int], None]:
    """The fused dycore's k-step legality: a callable that plans the CUDA
    k-step kernel's tile (`tiling.dycore_kstep_tile`) on the local slab
    padded by `k * halo` a side at the grid's nz, raising ValueError where
    the kernel refuses k (nz outside 2..64, a slab under 2k rows, a tile
    no cluster of 8 blocks covers)."""
    nz, ny, nx = (int(g) for g in grid_shape)
    py, px = (int(s) for s in mesh_shape)

    def check(k: int) -> None:
        _tiling.dycore_kstep_tile(ny // py + 2 * k * halo,
                                  nx // px + 2 * k * halo, k, nz=nz)
    return check


def resolve_k_steps(grid_shape: Sequence[int], dtype, mesh_shape,
                    *, n_fields: int = 4, halo: int = 2, max_k: int = 8,
                    hier: Optional[hw.Hierarchy] = None,
                    latency_s: Optional[float] = None,
                    utilization: float = 0.85,
                    flops_per_point: Optional[float] = None,
                    exchange_model: Optional[Callable] = None,
                    kstep_check: Optional[Callable] = None,
                    spec: Optional[hwspec.HardwareSpec] = None) -> int:
    """`plan_k_steps` walked down until `kstep_check(k)` accepts k (or k is
    1). A k is legal when the CUDA k-step kernel takes it: the default
    check is the fused dycore's, `tiling.dycore_kstep_tile` on the padded
    local slab at the grid's nz (2 <= nz <= 64, a tile that fits a thread
    block cluster), raising ValueError otherwise. Ops whose launches each
    plan their own tile pass `kstep_check=lambda k: None` (hdiff)."""
    k = plan_k_steps(grid_shape, dtype, mesh_shape, n_fields=n_fields,
                     halo=halo, max_k=max_k, hier=hier, latency_s=latency_s,
                     utilization=utilization, flops_per_point=flops_per_point,
                     exchange_model=exchange_model, spec=spec)
    if kstep_check is None:
        kstep_check = dycore_kstep_check(grid_shape, mesh_shape, halo)
    while k > 1:
        try:
            kstep_check(k)
            break
        except ValueError:
            k -= 1
    return k


# ---------------------------------------------------------------------------
# Measured tuning: the paper's "auto-tuned" mode
# ---------------------------------------------------------------------------


def measure_walltime(fn: Callable[[], Any], repeats: int = 3,
                     device="cpu") -> float:
    """Median seconds of `fn()` over `repeats` calls, after one untimed
    warm-up call. On a CUDA `device` each call is timed with CUDA events on
    the current stream, since the kernels it queues run after it returns;
    on the CPU with the host clock (`fn` must then finish its work)."""
    device = torch.device(device)
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(max(1, repeats)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e-3)
    else:
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


# Process-wide counters of the disk cache (tests and the smoke read them).
TUNE_CACHE_STATS: Dict[str, int] = {"hits": 0, "misses": 0, "stores": 0}

_TUNE_CACHE_ENV = "REPRO_TUNE_CACHE"


def backend_name(device) -> str:
    """What a measurement ran on, for the cache key: `"cpu"`, or the
    card's name and the CUDA version PyTorch was built with."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return f"{torch.cuda.get_device_name(device)} cuda {torch.version.cuda}"


def tune_cache_dir() -> str:
    """`$REPRO_TUNE_CACHE`, or `~/.cache/repro_torch/tune`."""
    env = os.environ.get(_TUNE_CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tune")


def tune_cache_key(program_key: Any, spec: hwspec.HardwareSpec,
                   backend: str) -> str:
    """Content key of one (program, machine, device) tuning decision.
    `program_key` has a deterministic repr (the planner's
    `plan_cache_key`, a frozen dataclass); the spec adds its content
    fingerprint, so editing a spec's JSON invalidates its measurements."""
    payload = f"{program_key!r}|spec={spec.fingerprint}|backend={backend}"
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def tune_cache_load(key: str) -> Optional[Dict[str, Any]]:
    """A stored tuning decision, or None; counts a hit or a miss."""
    path = os.path.join(tune_cache_dir(), f"{key}.json")
    try:
        with open(path) as fh:
            entry = json.load(fh)
    except (OSError, json.JSONDecodeError):
        TUNE_CACHE_STATS["misses"] += 1
        return None
    TUNE_CACHE_STATS["hits"] += 1
    return entry


def tune_cache_store(key: str, entry: Dict[str, Any]) -> None:
    """Store a tuning decision atomically (a temporary file, then a
    rename), so processes racing on one key each leave a whole file."""
    cache_dir = tune_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(entry, fh, sort_keys=True)
        os.replace(tmp, os.path.join(cache_dir, f"{key}.json"))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    TUNE_CACHE_STATS["stores"] += 1
