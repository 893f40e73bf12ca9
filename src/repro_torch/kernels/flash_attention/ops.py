"""Public flash-attention entry point: the tensor's device decides what
runs, and block selection against the card's shared memory.

A CPU tensor takes the plain version (`ref.mha`); a CUDA tensor launches
the CUDA kernel (`flash.flash_mha_cuda`) or raises. There is no fallback.
Where an input requires grad, the call goes through `FlashFn`: the same
forward, and a backward that recomputes the plain version and returns its
gradients, as XLA differentiates the JAX package's jnp attention (a
hand-written backward kernel is later work, ROADMAP queue 2).

`auto_blocks` plays the part of the JAX package's VMEM-budget rule: the
largest (block_q, block_k) the kernel is built for whose working set (q,
k, v and score tiles in fp32, `flash.smem_bytes`) fits the dynamic shared
memory one block may opt into on the H100 (227 KB). T and S need not
divide by the blocks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash import (BLOCKS,
                                                       check_operands,
                                                       flash_mha_cuda,
                                                       smem_bytes)

SMEM_BUDGET = 232448       # bytes of shared memory a block may opt into


def auto_blocks(hd: int, budget: int = SMEM_BUDGET) -> Tuple[int, int]:
    """The largest (block_q, block_k) of `flash.BLOCKS` whose shared-memory
    working set fits `budget`. The tiles are fp32 whatever the I/O dtype,
    and any T, S tile (the last block may be ragged), so only `hd` and the
    budget decide."""
    for bq, bk in BLOCKS:
        if smem_bytes(hd, bq, bk) <= budget:
            return bq, bk
    raise ValueError(f"flash_attn: no block of {BLOCKS} fits {budget} bytes "
                     f"of shared memory at head_dim {hd}")


def _forward(q, k, v, causal, window, softcap):
    if q.device.type == "cpu":
        check_operands(q, k, v, window)
        return ref.mha(q, k, v, causal=causal, window=window,
                       softcap=softcap)
    bq, bk = auto_blocks(q.shape[3])
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
