"""Public flash-attention entry point: the tensor's device decides what
runs, and block selection against the card's shared memory.

A CPU tensor takes the plain version (`ref.mha`); a CUDA tensor launches
the CUDA kernel of its dtype (`flash.flash_mha_cuda`: bfloat16 on the
tensor cores, float32 on the fp32 cores) or raises. There is no fallback.
Where an input requires grad, the call goes through `FlashFn`: the same
forward, and a backward that recomputes the plain version and returns its
gradients, as XLA differentiates the JAX package's jnp attention (a
hand-written backward kernel is later work, ROADMAP queue 2).

`auto_blocks` (`flash.auto_blocks`) plays the part of the JAX package's
VMEM-budget rule: the largest (block_q, block_k) the route is built for
whose working set (`flash.smem_bytes`: fp32 q, k, v and score tiles, or
the bf16 q tile and two stages of k and v) fits the dynamic shared memory
one block may opt into on the H100 (227 KB). T and S need not divide by
the blocks.

On a fake or meta tensor (a dry-run's trace, `core/op_cost.py`) the
forward launches nothing, whatever the tensor's device: it returns an
empty output and records one call of the kernel with its own cost,
`flash_flops` (the (q, k) pairs of the blocks it visits) and
`flash_traffic_bytes` (the JAX package's formula at the port's
`auto_blocks`). `FlashFn`'s backward is the plain recompute, so a trace
counts it as the operations the card runs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import op_cost
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash import (SMEM_BUDGET,  # noqa: F401
                                                       auto_blocks,
                                                       check_operands,
                                                       flash_mha_cuda)


def flash_traffic_bytes(b: int, t: int, s: int, h: int, kh: int, hd: int,
                        dtype_bytes: int = 2, block_q: int = 0) -> float:
    """Modelled main-memory bytes of the kernel (the JAX package's
    `flash_traffic_bytes`): q and o once, k and v once a q block, the
    block from `auto_blocks` of the route of `dtype_bytes`."""
    dtype = torch.bfloat16 if dtype_bytes <= 2 else torch.float32
    bq = block_q or auto_blocks(hd, dtype=dtype)[0]
    nq = max(t // bq, 1)
    q_o = 2 * b * t * h * hd * dtype_bytes
    kv = 2 * b * s * kh * hd * dtype_bytes * nq
    return float(q_o + kv)


def flash_flops(b: int, t: int, s: int, h: int, hd: int, causal: bool,
                window: int, dtype=torch.bfloat16) -> float:
    """The kernel's FLOPs: 4 x hd a (query, key) pair of every key block
    each query block visits (`kv_range` of `csrc/flash_attn*.cu`: a causal
    block stops at its last row, a windowed one starts at its first row's
    window)."""
    bq, bk = auto_blocks(hd, dtype=dtype)
    pairs = 0
    for qa in range(0, t, bq):
        qe = min(qa + bq, t) - 1
        lo, hi = 0, s
        if not window or qe - window + 1 <= s - 1:
            if causal:
                hi = min(s, qe + 1)
            if window:
                lo = max(0, qa - window + 1)
        blocks = max(math.ceil(hi / bk) - lo // bk, 0)
        pairs += (qe - qa + 1) * blocks * bk
    return 4.0 * b * h * hd * pairs


def _traced(q, k, v, causal, window):
    """A trace's call: nothing launched, the kernel's cost recorded."""
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    op_cost.record_kernel(
        "flash_attn", flash_flops(b, t, s, h, hd, causal, window, q.dtype),
        flash_traffic_bytes(b, t, s, h, kh, hd, q.element_size()))
    return torch.empty_like(q)


def _forward(q, k, v, causal, window, softcap):
    if op_cost.is_fake(q):
        check_operands(q, k, v, window)
        return _traced(q, k, v, causal, window)
    if q.device.type == "cpu":
        check_operands(q, k, v, window)
        return ref.mha(q, k, v, causal=causal, window=window,
                       softcap=softcap)
    bq, bk = auto_blocks(q.shape[3], dtype=q.dtype)
    return flash_mha_cuda(q, k, v, causal=causal, window=window,
                          softcap=softcap, block_q=bq, block_k=bk)


class FlashFn(torch.autograd.Function):
    """Flash attention with its gradient: the kernel (CUDA) or the plain
    version (CPU) forward; backward recomputes `ref.mha` under autograd
    and returns its gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, softcap)
        return _forward(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out = ref.mha(*qkv, causal=causal, window=window,
                          softcap=softcap)
            dq, dk, dv = torch.autograd.grad(out, qkv, do)
        return dq, dk, dv, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              softcap: float = 0.0) -> torch.Tensor:
    """Auto-tiled flash attention. q: (B,T,H,hd); k, v: (B,S,KH,hd).
    Differentiable through `FlashFn` where an input requires grad."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        check_operands(q, k, v, window)
        return FlashFn.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap)
