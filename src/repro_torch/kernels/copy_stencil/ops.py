"""Public copy-stencil entry point: the tensor's device decides what runs.

A CPU tensor takes the plain version (`ref.copy_stencil`); a CUDA tensor
launches the CUDA kernel (`copy_stencil.copy_cuda`) or raises. There is no
fallback. Both refuse what `copy_pallas` refuses.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.copy_stencil import ref as _ref
from repro_torch.kernels.copy_stencil.copy_stencil import check_rows, copy_cuda


def copy_stencil(src: torch.Tensor, tr: int = 256) -> torch.Tensor:
    """Identity copy of a `(rows, cols)` tensor, `rows % tr == 0`."""
    if src.device.type == "cpu":
        check_rows(src, tr)
        return _ref.copy_stencil(src)
    return copy_cuda(src, tr=tr)
