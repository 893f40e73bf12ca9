"""Public slot-guard entry point: the leaves' device decides what runs.

CPU leaves take the plain version (`ref.slot_guard`); CUDA leaves launch
the CUDA kernel (`slot_guard.slot_guard_cuda`) or raise. There is no
fallback.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.slot_guard import ref as _ref
from repro_torch.kernels.slot_guard.slot_guard import slot_guard_cuda


def slot_guard(leaves: Sequence[torch.Tensor], limit: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(ok, fp)` per slot of `(E, ...)` leaves: ok (E,) bool, fp (E,)
    int64 holding the JAX package's uint32 digest."""
    leaves = list(leaves)
    if all(t.device.type == "cpu" for t in leaves):
        return _ref.slot_guard(leaves, limit)
    return slot_guard_cuda(leaves, limit)
