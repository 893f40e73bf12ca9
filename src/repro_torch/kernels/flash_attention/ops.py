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
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash import (SMEM_BUDGET,  # noqa: F401
                                                       auto_blocks,
                                                       check_operands,
                                                       flash_mha_cuda)


def _forward(q, k, v, causal, window, softcap):
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
