"""NeroEngine: the paper's execution model as a first-class API.

A port of `repro.core.engine`:

    engine = NeroEngine()                       # the H100; device="cuda"
    tuned = engine.plan("hdiff", grid_shape=(64, 256, 256), dtype="float32")
    out = engine.run(tuned, src)

`plan` runs the multi-objective window autotuner (the paper's OpenTuner
stage) once per (op, grid, dtype) over the engine's memory hierarchy and
caches the result; `estimate` is the chosen plan's modelled time and energy.
`run` dispatches `hdiff`, `vadvc` and `copy` through the port's
`kernels/*/ops.py`: on a CUDA engine the hand-written kernels, hdiff and
vadvc launched with the kernel tile the plan's window maps to
(`tiling.cuda_tile_for`); on a CPU engine their plain PyTorch versions.
Operands must lie on the engine's device. Planning is arithmetic and needs
no card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import autotune, hierarchy as hw, perfmodel, tiling
from repro_torch.core.tiling import COPY, HDIFF, LRU_SCAN, VADVC, OpSpec, TilePlan
from repro_torch.weather.fields import dtype_name
from repro_torch.weather.program import same_device

OPS: Dict[str, OpSpec] = {
    "hdiff": HDIFF,
    "vadvc": VADVC,
    "copy": COPY,
    "lru_scan": LRU_SCAN,
}


@dataclasses.dataclass
class NeroEngine:
    """Plan + dispatch for the framework's memory-bound operators."""

    hier: Optional[hw.Hierarchy] = None
    device: torch.device = "cuda"
    chips: int = 1

    def __post_init__(self):
        self.hier = self.hier or hw.h100_sxm()
        self.device = torch.device(self.device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device {self.device}: expected 'cuda' or "
                             f"'cpu'")
        self._plans: Dict[Tuple[str, Tuple[int, ...], str],
                          autotune.TunedResult] = {}

    # -- planning ------------------------------------------------------------

    def plan(self, op_name: str, grid_shape: Tuple[int, ...], dtype,
             measure: Optional[Callable[[TilePlan], float]] = None
             ) -> autotune.TunedResult:
        """The tuned plan of `op_name` on `grid_shape` (cached); with
        `measure` (seconds for a `TilePlan`), the measured pick, which
        replaces the cached one."""
        key = (op_name, tuple(grid_shape), dtype_name(dtype))
        if key not in self._plans or measure is not None:
            self._plans[key] = autotune.tune(
                OPS[op_name], grid_shape, dtype, self.hier,
                chips=self.chips, measure=measure)
        return self._plans[key]

    def estimate(self, op_name: str, grid_shape: Tuple[int, ...], dtype
                 ) -> perfmodel.PerfEstimate:
        return self.plan(op_name, grid_shape, dtype).est

    # -- dispatch ------------------------------------------------------------

    def run(self, tuned: autotune.TunedResult, *fields) -> torch.Tensor:
        """Launch `tuned`'s op on its operands: hdiff `(src[, coeff])`,
        vadvc `(u_stage, wcon, u_pos, utens, utens_stage)`, copy `(src)`,
        as the JAX engine takes them. The tensors must lie on the engine's
        device."""
        plan = tuned.plan
        name = plan.op.name
        if name not in ("hdiff", "vadvc", "copy"):
            raise NotImplementedError(name)
        for i, t in enumerate(fields[:5] if name == "vadvc" else fields[:1]):
            if not isinstance(t, torch.Tensor) or not same_device(
                    t.device, self.device):
                raise ValueError(
                    f"{name}: operand {i} is on "
                    f"{getattr(t, 'device', type(t).__name__)} but the "
                    f"engine runs on {self.device}")
        if name == "hdiff":
            return self._run_hdiff(plan, *fields)
        if name == "vadvc":
            return self._run_vadvc(plan, *fields)
        return self._run_copy(plan, *fields)

    def _run_hdiff(self, plan: TilePlan, src, coeff: float | None = None):
        from repro_torch.kernels.hdiff import ops, ref
        coeff = ref.DEFAULT_COEFF if coeff is None else coeff
        return ops.hdiff(src, coeff=coeff, tile=tiling.cuda_tile_for(plan))

    def _run_vadvc(self, plan: TilePlan, u_stage, wcon, u_pos, utens,
                   utens_stage):
        from repro_torch.kernels.vadvc import ops
        return ops.vadvc(u_stage, wcon, u_pos, utens, utens_stage,
                         tile=tiling.cuda_tile_for(plan))

    def _run_copy(self, plan: TilePlan, src):
        # The copy kernel streams the whole buffer; the plan's window is
        # the model's, as on the TPU.
        from repro_torch.kernels.copy_stencil import ops
        return ops.copy_stencil(src)
