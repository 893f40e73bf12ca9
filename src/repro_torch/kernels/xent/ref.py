"""Plain PyTorch oracle for the fused cross-entropy kernel.

A port of `repro.kernels.xent.ref`: the full (N, Vp) logits in fp32 — the
thing the kernel exists to avoid — so it is the correctness reference, the
plain version the kernel is held against on the card and what runs on a
CPU tensor. Physical vocab-padding columns (>= `vocab`) take the finite
-1e30 of the JAX package; `valid` zeroes rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def xent_rows(hidden: torch.Tensor, head: torch.Tensor,
              targets: torch.Tensor, valid: Optional[torch.Tensor] = None,
              vocab: int = 0, softcap: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row next-token NLL and log-normaliser, both fp32 (N,).

    hidden: (N, D); head: (D, Vp); targets: (N,) integer < vocab; valid:
    (N,) mask (None: every row); vocab: logical vocab size (0: Vp)."""
    vp = head.shape[1]
    lg = hidden.float() @ head.float()
    if softcap:
        lg = torch.tanh(lg / softcap) * softcap
    if vocab and vocab < vp:
        lg = torch.where(torch.arange(vp, device=lg.device) < vocab, lg,
                         NEG_INF)
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, targets.long()[:, None])[:, 0]
    nll = lse - gold
    if valid is not None:
        nll = nll * valid.float()
    return nll, lse


def xent(hidden: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
         valid: Optional[torch.Tensor] = None, vocab: int = 0,
         softcap: float = 0.0) -> torch.Tensor:
    """Sum of next-token NLL (scalar fp32), as the JAX package's
    `ref.xent`."""
    return xent_rows(hidden, head, targets, valid, vocab, softcap)[0].sum()
