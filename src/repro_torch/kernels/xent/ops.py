"""Public cross-entropy entry points: the tensor's device decides what
runs, and the gradient.

`xent_rows` (no gradient): a CPU tensor takes the plain version
(`ref.xent_rows`); a CUDA tensor launches the kernel (`xent.xent_cuda`) or
raises. There is no fallback.

`xent` and `fused_xent_mean` go through `XentFn`, whose forward is
`xent_rows` and whose backward, the same on both devices, recomputes the
logits 512 rows at a time (the JAX package's chunk) with `torch.matmul` in
fp32, the product the forward computes, and forms softmax − onehot from the
forward's saved log-normaliser, so it takes no second streaming pass and
never holds the (N, Vp) logits (8.4 GB at recurrentgemma's 8188 x 256000
in fp32). The two products that carry the gradient back, d hidden and
d head, run in the activation dtype. The gradient is zero on padding
columns and invalid rows and carries tanh' where `softcap` is set. A
hand-written backward kernel is later work (ROADMAP queue 2).

On a fake or meta tensor (a dry-run's trace, `core/op_cost.py`)
`xent_rows` launches nothing, whatever the tensor's device: it returns
empty outputs and records one call of the kernel with its own cost,
2 x N x D x Vp FLOPs (an exponential a logit, and a tanh where `softcap`
is set) and its operands' and outputs' bytes. The backward is plain
PyTorch on both devices, so a trace counts it as the operations the card
runs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import op_cost
from repro_torch.kernels.xent import ref
from repro_torch.kernels.xent.xent import check_operands, xent_cuda

CHUNK = 512                 # rows a backward chunk (`lm.chunked_xent`'s)


def xent_rows(hidden: torch.Tensor, head: torch.Tensor,
              targets: torch.Tensor, valid: Optional[torch.Tensor] = None, *,
              vocab: int = 0, softcap: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row NLL (times `valid`) and log-normaliser, fp32 (N,).
    hidden (N, D); head (D, Vp); targets (N,)."""
    if op_cost.is_fake(hidden):
        check_operands(hidden, head, targets, valid, vocab)
        return _traced(hidden, head, targets, valid, softcap)
    if hidden.device.type == "cpu":
        check_operands(hidden, head, targets, valid, vocab)
        return ref.xent_rows(hidden, head, targets, valid, vocab, softcap)
    return xent_cuda(hidden, head, targets, valid, vocab=vocab,
                     softcap=softcap)


def _traced(hidden, head, targets, valid, softcap):
    """A trace's call: nothing launched, the kernel's cost recorded."""
    n, d = hidden.shape
    vp = head.shape[1]
    nll = torch.empty(n, dtype=torch.float32, device=hidden.device)
    lse = torch.empty_like(nll)
    ins = (hidden, head, targets) + ((valid,) if valid is not None else ())
    op_cost.record_kernel(
        "xent", 2.0 * n * d * vp,
        sum(t.numel() * t.element_size() for t in ins + (nll, lse)),
        transcendentals=n * vp * (2 if softcap else 1))
    return nll, lse


def _backward(hidden, head, targets, valid, lse, dnll, vocab, softcap):
    n, d = hidden.shape
    vp = head.shape[1]
    w = head.to(hidden.dtype)
    # the forward's fp32 product, so that `lse` normalises these logits
    w32 = head.float()
    keep = torch.arange(vp, device=hidden.device) < (vocab or vp)
    scale = dnll.float() * valid.float()
    dh = torch.empty_like(hidden)
    # d head accumulates in fp32, in head's own memory order (embed.T when
    # tied: (Vp, D) rows)
    tied = head.stride(0) == 1 and head.stride(1) != 1
    dw = torch.zeros((vp, d) if tied else (d, vp), dtype=torch.float32,
                     device=hidden.device)
    for i in range(0, n, CHUNK):
        h_c = hidden[i:i + CHUNK]
        rows = torch.arange(h_c.shape[0], device=hidden.device)
        lg = h_c.float() @ w32
        if softcap:
            tz = torch.tanh(lg / softcap)
            lg = tz * softcap
        lg = torch.where(keep, lg, ref.NEG_INF)
        p = torch.exp(lg - lse[i:i + CHUNK, None])
        p[rows, targets[i:i + CHUNK].long()] -= 1.0
        p *= scale[i:i + CHUNK, None]
        if softcap:
            p *= 1.0 - tz * tz
        g = torch.where(keep, p, 0.0).to(hidden.dtype)
        dh[i:i + CHUNK] = g @ w.T
        if tied:
            dw += (g.T @ h_c).float()
        else:
            dw += (h_c.T @ g).float()
    dw = dw.to(head.dtype)
    return dh, (dw.T if tied else dw)


class XentFn(torch.autograd.Function):
    """Per-row NLL with its gradient (module docstring)."""

    @staticmethod
    def forward(ctx, hidden, head, targets, valid, vocab, softcap):
        nll, lse = xent_rows(hidden, head, targets, valid, vocab=vocab,
                             softcap=softcap)
        ctx.save_for_backward(hidden, head, targets, valid, lse)
        ctx.opts = (vocab, softcap)
        return nll

    @staticmethod
    def backward(ctx, dnll):
        hidden, head, targets, valid, lse = ctx.saved_tensors
        dh, dw = _backward(hidden, head, targets, valid, lse, dnll,
                           *ctx.opts)
        return dh, dw, None, None, None, None


def xent(hidden: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
         valid: Optional[torch.Tensor] = None, *, vocab: int = 0,
         softcap: float = 0.0) -> torch.Tensor:
    """Per-row next-token NLL (fp32 (N,), times `valid`), differentiable
    in hidden and head. hidden (N, D); head (D, Vp); targets (N,)."""
    if valid is None:
        valid = torch.ones(hidden.shape[0], dtype=torch.float32,
                           device=hidden.device)
    return XentFn.apply(hidden, head, targets, valid, vocab, softcap)


def fused_xent_mean(hidden: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor, *, vocab: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Mean next-token NLL over (B, T) without materializing logits.

    hidden: (B, T, D); head: (D, Vp); targets: (B, T). The JAX wrapper pads
    the rows to its block with valid = 0; the kernel takes any N, so
    nothing is padded here."""
    b, t, d = hidden.shape
    n = b * t
    nll = xent(hidden.reshape(n, d), head, targets.reshape(n), vocab=vocab,
               softcap=softcap)
    return nll.sum() / n
