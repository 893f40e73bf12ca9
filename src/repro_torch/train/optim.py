"""AdamW with mixed precision (bf16 params, fp32 master + moments), cosine
schedule with warmup, global-norm clipping.

A port of `repro.train.optim`, with its arithmetic step for step:
decoupled weight decay inside `lr·(…)`, clipping by the global norm of the
gradients, bias correction, and the schedule, all in fp32 tensors on the
parameters' device (not `torch.optim.AdamW`, whose update order differs).
The optimizer state holds, for every parameter by its name in
`named_parameters()`, the fp32 moments `m`, `v` and master copy `master`,
and a scalar int32 `step`. `apply_updates` updates the state and the
parameters in place (the JAX package returns new trees), so a step holds
no second copy of either.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an int32 tensor), fp32."""
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: nn.Module) -> Dict[str, object]:
    named = list(params.named_parameters())
    dev = named[0][1].device
    return {
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
              for k, p in named},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
              for k, p in named},
        "master": {k: p.detach().to(torch.float32, copy=True)
                   for k, p in named},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params: nn.Module,
                  opt_state: Dict[str, object],
                  grads: Sequence[torch.Tensor]
                  ) -> Tuple[nn.Module, Dict[str, object],
                             Dict[str, torch.Tensor]]:
    """One AdamW step from `grads` (in `named_parameters()` order), in
    place; returns (params, opt_state, {"grad_norm", "lr"})."""
    step = opt_state["step"]
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(gnorm),
                          cfg.clip_norm / torch.clamp_min(gnorm, 1e-9))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** (step.float() + 1.0)
    bc2 = 1.0 - b2 ** (step.float() + 1.0)
    for (name, p), g in zip(params.named_parameters(), grads):
        m, v = opt_state["m"][name], opt_state["v"][name]
        master = opt_state["master"][name]
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        master.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * master))
        p.copy_(master)
    opt_state["step"] = step + 1
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
