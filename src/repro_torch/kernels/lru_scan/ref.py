"""Plain PyTorch oracle for the linear-recurrence sweep
h_t = a_t h_{t-1} + b_t, h_{-1} = 0.

A port of `repro.kernels.lru_scan.ref`: the same associative combine
`(a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r + b_r)`, applied here as a
log-depth doubling scan (Hillis-Steele) along the time axis, in float32
whatever the input dtype (the kernel's fp32 carry); the result is in a's
dtype. Layout: time on axis -2, channels last — (T, C) as the TPU kernel
takes it, or the model's batched (B, T, C).
"""

from __future__ import annotations

import torch


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (..., T, C) -> h: (..., T, C), h_0 = b_0."""
    acc_a, acc_b = a.float(), b.float()
    t = a.shape[-2]
    shift = 1
    while shift < t:
        new_b = acc_b.clone()
        new_a = acc_a.clone()
        new_b[..., shift:, :] = (acc_b[..., :-shift, :] * acc_a[..., shift:, :]
                                 + acc_b[..., shift:, :])
        new_a[..., shift:, :] = acc_a[..., :-shift, :] * acc_a[..., shift:, :]
        acc_a, acc_b = new_a, new_b
        shift *= 2
    return acc_b.to(a.dtype)
