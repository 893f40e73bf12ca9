"""Public LRU-sweep entry point: the tensor's device decides what runs.

A CPU tensor takes the plain version (`ref.lru_scan_ref`); a CUDA tensor
launches the CUDA kernel (`lru_scan.lru_scan_cuda`) or raises. There is no
fallback.

Where an operand requires grad, the sweep goes through `LruScanFn`. Its
backward is the same sweep run backwards in time: with g_t = dL/dh_t summed
over every path, g_t = dh_t + a_{t+1} g_{t+1} (a_T = 0), so
g = reverse_sweep(a shifted one step, dh); then db = g and
da_t = g_t h_{t-1} (h_{-1} = 0). On the card the reverse sweep is the
kernel's `reverse` mode; on the CPU the plain version on flipped operands.

On a fake or meta tensor (a dry-run's trace, `core/op_cost.py`) a sweep
launches nothing, whatever the tensor's device: it returns an empty
output and records one call of the kernel with its bytes in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import op_cost
from repro_torch.kernels.lru_scan import ref as _ref
from repro_torch.kernels.lru_scan.lru_scan import (check_operands,
                                                   lru_scan_cuda)


def sweep(a: torch.Tensor, b: torch.Tensor, *,
          reverse: bool = False) -> torch.Tensor:
    """The sweep without a gradient: h_t = a_t h_{t-1} + b_t, h_{-1} = 0,
    along axis -2 of (T, C) or (B, T, C) operands (with `reverse`,
    h_t = a_t h_{t+1} + b_t from the last step down); in a's dtype."""
    if op_cost.is_fake(a):
        check_operands(a, b)
        h = torch.empty_like(a)
        # a multiply-add a step and channel
        op_cost.record_kernel("lru_scan", 2.0 * a.numel(),
                              sum(t.numel() * t.element_size()
                                  for t in (a, b, h)))
        return h
    if a.device.type == "cpu":
        check_operands(a, b)
        if reverse:
            return _ref.lru_scan_ref(a.flip(-2), b.flip(-2)).flip(-2)
        return _ref.lru_scan_ref(a, b)
    return lru_scan_cuda(a, b, reverse=reverse)


class LruScanFn(torch.autograd.Function):
    """The sweep with its gradient: forward h = sweep(a, b); backward the
    reverse sweep of dh (module docstring)."""

    @staticmethod
    def forward(ctx, a, b):
        h = sweep(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        t = a.shape[-2]
        # a_{t+1} at step t, 0 past the last step
        a_next = F.pad(a.narrow(-2, 1, t - 1), (0, 0, 0, 1))
        g = sweep(a_next.contiguous(), dh.to(a.dtype).contiguous(),
                  reverse=True)
        h_prev = F.pad(h.narrow(-2, 0, t - 1), (0, 0, 1, 0))
        da = (g.float() * h_prev.float()).to(a.dtype)
        return da, g.to(a.dtype)


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t, h_{-1} = 0, along axis -2 of (T, C) or
    (B, T, C) operands; the result is in a's dtype. Differentiable through
    `LruScanFn` where an operand requires grad."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        check_operands(a, b)
        return LruScanFn.apply(a, b)
    return sweep(a, b)
