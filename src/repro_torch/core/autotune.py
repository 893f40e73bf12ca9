"""Multi-objective tile auto-tuner: the paper's OpenTuner stage.

A port of `repro.core.autotune` (`tune`, the op registry, the Pareto front
and `measure_walltime`). NERO selects its window by multi-objective
optimization (performance against FPGA resource use) and shows the Pareto
optimum shifting with precision (paper Fig. 6). Here the objectives are
(predicted or measured time, near-memory bytes); the search is exhaustive
over the legal tile space, which near-memory capacity keeps small.

Not ported yet (ROADMAP queue 1): `plan_k_steps` / `resolve_k_steps`, which
need `core/memmodel.py` (single-device `compile` resolves k = 1), and the
measured-tuning disk cache, whose one consumer is `compile(tune="measure")`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import hierarchy as hw
from repro_torch.core import hwspec
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
