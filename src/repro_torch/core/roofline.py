"""Roofline terms of one traced step.

A port of `repro.core.roofline`. The dry-run (`launch/dryrun.py`) traces
each (arch x shape x mesh) cell's step on fake tensors as rank 0 of a fake
world and counts its work with `core/op_cost.py`; this module turns those
per-device counts into the three roofline terms:

  compute term    = FLOPs_per_device / peak_FLOP/s
  memory term     = bytes_per_device / main-memory bandwidth
  collective term = collective_wire_bytes_per_device / link bandwidth

The JAX package parses collectives out of compiled HLO text; the port has
no HLO, so `collective_bytes` reads the counter's record instead: result
bytes per device of each kind (`all-reduce`, `all-gather`,
`reduce-scatter`, `all-to-all`, `collective-permute`), with the same
ring-algorithm wire factors.

One difference by design: `analyze(spec=None)` takes
`hwspec.default_spec()`, the H100 SXM (989 TFLOP/s bf16, 3.35 TB/s,
NVLink 50 GB/s a link) unless `REPRO_HWSPEC` names another, where the JAX
package takes the TPU v5e constants of its `core/hierarchy.py`. Pass
`spec` to pick the machine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import hwspec

# Ring-algorithm wire-bytes factor per result byte (n = group size; the
# n->inf limit as the conservative constant).
_WIRE_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_H100_BF16 = hwspec.load_spec("h100_sxm").peak_flops["bfloat16"]


def collective_bytes(cost) -> Dict[str, int]:
    """Per-kind result bytes (per device) of a counted step (an
    `op_cost.Cost`): the twin of the JAX package's HLO parse."""
    return {k: int(v) for k, v in cost.collective_bytes.items()}


def wire_bytes(coll: Dict[str, int]) -> float:
    return sum(_WIRE_FACTOR.get(op, 1.0) * b for op, b in coll.items())


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    useful_flops_ratio: float       # MODEL_FLOPS / (counted flops x chips)
    chips: int
    # Peak FLOP/s of the machine the terms were computed against (the
    # spec's), so `roofline_fraction` stays consistent with `analyze(spec=)`.
    peak_flops: float = _H100_BF16

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful model FLOP/s achieved at the bound, vs chip peak."""
        if self.step_time_s == 0:
            return 0.0
        achieved = self.model_flops_total / self.step_time_s
        return achieved / (self.chips * self.peak_flops)


def analyze(cost: Dict[str, float], coll: Dict[str, int], chips: int,
            model_flops_total: float, dtype_bytes: int = 2,
            spec=None) -> RooflineTerms:
    """`cost`: {"flops", "bytes accessed"[, "bytes fused"]} per device.
    The memory term takes "bytes fused" where given and else "bytes
    accessed", as the JAX package's does; the eager port fuses nothing,
    so the dry-run gives only "bytes accessed". `spec` (a
    `hwspec.HardwareSpec`, default `hwspec.default_spec()`) is the machine
    whose peaks the terms are measured against."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes fused") or cost.get("bytes accessed", 0.0))
    wire = wire_bytes(coll)
    spec = spec or hwspec.default_spec()
    peak = spec.peak_flops["bfloat16" if dtype_bytes <= 2 else "float32"]
    hbm_bw = spec.main.bandwidth_bytes_per_s
    link_bw = spec.collective.bandwidth_bytes_per_s
    compute_s = flops / peak
    memory_s = byts / hbm_bw
    collective_s = wire / link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    ratio = (model_flops_total / (flops * chips)) if flops else 0.0
    return RooflineTerms(
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes_per_device=wire, compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s, dominant=dominant,
        model_flops_total=model_flops_total, useful_flops_ratio=ratio,
        chips=chips, peak_flops=peak)


def model_flops(param_count: int, active_param_count: int, tokens: int,
                kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference fwd), N = active."""
    n = active_param_count
    return (6.0 if kind == "train" else 2.0) * n * tokens
