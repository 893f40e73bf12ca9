"""Public LRU-sweep entry point: the tensor's device decides what runs.

A CPU tensor takes the plain version (`ref.lru_scan_ref`); a CUDA tensor
launches the CUDA kernel (`lru_scan.lru_scan_cuda`) or raises. There is no
fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.lru_scan import ref as _ref
from repro_torch.kernels.lru_scan.lru_scan import (check_operands,
                                                   lru_scan_cuda)


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t, h_{-1} = 0, along axis -2 of (T, C) or
    (B, T, C) operands; the result is in a's dtype."""
    if a.device.type == "cpu":
        check_operands(a, b)
        return _ref.lru_scan_ref(a, b)
    return lru_scan_cuda(a, b)
