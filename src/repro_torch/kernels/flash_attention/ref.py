"""Plain PyTorch oracle for the flash-attention kernel.

A port of `repro.kernels.flash_attention.ref`: materialized-softmax GQA
attention with the same masking semantics (causal / sliding window / logit
softcap, the finite -1e30 sentinel) — the kernel's plain version: what
`ops.flash_mha` runs on a CPU tensor, and what the kernel is held against.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0,
        softcap: float = 0.0) -> torch.Tensor:
    """q: (B, T, H, hd); k, v: (B, S, KH, hd); H % KH == 0.

    Returns (B, T, H, hd) in q's dtype. window > 0 keeps keys with
    0 <= qpos-kpos < window (sliding-window attention); causal masks
    kpos > qpos.
    """
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qs = (q.float() * (hd ** -0.5)).reshape(b, t, kh, g, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qs, k.float())
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", p, v.float())
    return out.reshape(b, t, h, hd).to(q.dtype)
