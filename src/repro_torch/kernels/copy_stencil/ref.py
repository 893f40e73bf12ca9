"""Plain PyTorch COSMO copy stencil (paper Fig. 2b): element-wise identity.

A port of `repro.kernels.copy_stencil.ref.copy_stencil`. The simplest COSMO
stencil; it characterizes the memory rate a platform sustains (the paper
uses it to find the PE-saturation point of HBM). Adding zeros forces a real
read and write, and turns -0.0 into +0.0, as the JAX oracle does; the CUDA
kernel copies bits.
"""

from __future__ import annotations

import torch


def copy_stencil(src: torch.Tensor) -> torch.Tensor:
    return src + torch.zeros_like(src)
