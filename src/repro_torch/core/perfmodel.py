"""Analytic per-plan performance/energy model (shared by the autotuner).

A port of `repro.core.perfmodel`, in the same float arithmetic. For a
`TilePlan` it derives the roofline terms (compute / main memory / near
memory / collective); predicted time is the largest of them (the dataflow
pipeline overlaps load and compute, the paper's design) plus one tile's
pipeline fill. Energy is the spec's per-class wall power times that time
where the spec gives one, else the bottom-up per-level pJ/byte sum.

Every entry point takes a `spec=` (a `hwspec.HardwareSpec`); the default is
`hwspec.default_spec()`, the H100 SXM unless `REPRO_HWSPEC` names another.
These are modelled numbers, never measurements.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.core import hierarchy as hw
from repro_torch.core import hwspec
from repro_torch.core.tiling import TilePlan


@dataclasses.dataclass(frozen=True)
class PerfEstimate:
    plan: TilePlan
    compute_s: float
    memory_s: float
    collective_s: float
    vmem_s: float
    time_s: float            # pipelined: max(terms) + fill latency
    gflops: float            # useful GFLOP/s at predicted time
    energy_j: float
    bottleneck: str
    hardware: Optional[str] = None      # spec name the model targeted
    kernel_class: Optional[str] = None  # "streaming" | "solver"

    @property
    def gflops_per_watt(self) -> float:
        if self.time_s == 0:
            return 0.0
        watts = self.energy_j / self.time_s
        return self.gflops / max(watts, 1e-9)


def gflops_per_watt(est: PerfEstimate) -> float:
    """Module-level spelling of `PerfEstimate.gflops_per_watt` (0.0 for a
    zero-time estimate)."""
    return est.gflops_per_watt


def estimate(plan: TilePlan,
             hier: Optional[hw.Hierarchy] = None,
             chips: int = 1,
             collective_bytes: float = 0.0,
             utilization: Optional[float] = None,
             spec: Optional[hwspec.HardwareSpec] = None) -> PerfEstimate:
    """Roofline-style time: the terms overlap under the dataflow pipeline,
    so throughput is set by the slowest stage. Peaks are derated by the
    spec's per-kernel-class sustained utilizations; an explicit
    `utilization` overrides both."""
    spec = spec or hwspec.default_spec()
    hier = hier or spec.hierarchy()
    cls_name = hwspec.kernel_class_name(plan.op)
    cls = spec.kernel_classes[cls_name]
    bw_util = utilization if utilization is not None else cls.bw_utilization
    fl_util = utilization if utilization is not None else cls.compute_utilization
    b = hw.dtype_bytes(plan.dtype)
    peak = hier.peak_flops_bf16 if b <= 2 else hier.peak_flops_fp32

    flops = plan.flops_total
    hbm_bytes = plan.hbm_bytes_total
    vmem_bytes = hbm_bytes * 2.0   # staged in + consumed out of near memory

    compute_s = flops / (chips * peak * fl_util)
    memory_s = hbm_bytes / (chips * hier.hbm.bandwidth_bytes_per_s * bw_util)
    vmem_s = vmem_bytes / (chips * hier.vmem.bandwidth_bytes_per_s)
    coll_s = collective_bytes / (chips * hier.ici_bw) if collective_bytes else 0.0

    # Pipeline fill: one tile's worth of latency before steady state.
    fill_s = (plan.hbm_bytes_per_tile /
              (hier.hbm.bandwidth_bytes_per_s * bw_util))
    time_s = max(compute_s, memory_s, vmem_s, coll_s) + fill_s

    terms = {"compute": compute_s, "memory": memory_s,
             "vmem": vmem_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)

    if cls.watts is not None:
        energy = cls.watts * time_s * chips
    else:
        energy = (hbm_bytes * hier.hbm.energy_pj_per_byte
                  + vmem_bytes * hier.vmem.energy_pj_per_byte
                  + collective_bytes * spec.collective.energy_pj_per_byte
                  + flops * spec.energy_pj_per_flop) * 1e-12
        energy += spec.idle_watts * time_s * chips   # static power floor

    gflops = flops / time_s / 1e9 if time_s > 0 else 0.0
    return PerfEstimate(plan=plan, compute_s=compute_s, memory_s=memory_s,
                        collective_s=coll_s, vmem_s=vmem_s, time_s=time_s,
                        gflops=gflops, energy_j=energy, bottleneck=bottleneck,
                        hardware=spec.name, kernel_class=cls_name)


def roofline_fraction(est: PerfEstimate,
                      hier: Optional[hw.Hierarchy] = None,
                      chips: int = 1,
                      spec: Optional[hwspec.HardwareSpec] = None) -> float:
    """Modelled fraction of the roofline bound for this op's arithmetic
    intensity (1.0 = on the roof); a zero-flop op (copy) scores as a
    fraction of peak main-memory bandwidth."""
    if hier is None:
        hier = (spec or (hwspec.load_spec(est.hardware) if est.hardware
                         else hwspec.default_spec())).hierarchy()
    b = hw.dtype_bytes(est.plan.dtype)
    peak = hier.peak_flops_bf16 if b <= 2 else hier.peak_flops_fp32
    ai = est.plan.op.arithmetic_intensity(est.plan.dtype)
    roof = min(peak, ai * hier.hbm.bandwidth_bytes_per_s) * chips
    if est.plan.op.flops_per_point == 0.0:
        if est.time_s == 0:
            return 0.0
        achieved_bw = est.plan.hbm_bytes_total / est.time_s
        return achieved_bw / (hier.hbm.bandwidth_bytes_per_s * chips)
    if est.time_s == 0:
        return 0.0
    achieved = est.plan.flops_total / est.time_s
    return achieved / roof


def estimate_by_hardware(op, grid_shape: Sequence[int], dtype,
                         specs: Optional[Sequence[str]] = None,
                         chips: int = 1,
                         collective_bytes: float = 0.0
                         ) -> Dict[str, PerfEstimate]:
    """The paper's cross-machine table, one op at a time: re-tune the tile
    plan for each spec's hierarchy and model it under that spec. Returns
    `{spec_name: PerfEstimate}` for every shipped spec by default."""
    from repro_torch.core import autotune   # local import: autotune imports us

    out: Dict[str, PerfEstimate] = {}
    for name in (specs or hwspec.available_specs()):
        spec = hwspec.load_spec(name)
        tuned = autotune.tune(op, grid_shape, dtype, spec=spec, chips=chips)
        out[name] = estimate(tuned.plan, chips=chips,
                             collective_bytes=collective_bytes, spec=spec)
    return out
