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

With DTensor parameters (a device mesh, `train/loop.py`) `m`, `v` and
`master` take each parameter's placements and `step` is replicated (the
JAX package's `o_shard`). The update is element-wise, so it runs on each
rank's local shards with the scalars as plain tensors; the clipping norm
is the whole model's (`global_norm` sums each shard's squares over the
mesh dims that shard it, never over copies).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.parallel import sharding as shd


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


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same storage); a tensor as it is."""
    return t.to_local() if shd.is_distributed(t) else t


def replicated_step(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`value` (0-dim) replicated on `like`'s mesh where `like` is a
    DTensor; else as it is."""
    if not shd.is_distributed(like):
        return value
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim)


def init_opt_state(params: nn.Module) -> Dict[str, object]:
    named = list(params.named_parameters())
    first = named[0][1]
    dev = _local(first).device
    return {
        "m": {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in named},
        "v": {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in named},
        "master": {k: p.detach().to(torch.float32, copy=True)
                   for k, p in named},
        "step": replicated_step(
            torch.zeros((), dtype=torch.int32, device=dev), first),
    }


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of all `tensors` together, summed in their order. A
    DTensor's local shard adds its squares once a shard: they are summed
    over the mesh dims that shard it (`Shard`), never over those holding
    copies (one all-reduce for the tensors sharing those dims)."""
    from torch.distributed.tensor import Shard

    sqs = [torch.sum(torch.square(_local(x).float())) for x in tensors]
    groups = {}
    for i, x in enumerate(tensors):
        if shd.is_distributed(x):
            dims = tuple(d for d, p in enumerate(x.placements)
                         if isinstance(p, Shard) and x.device_mesh.size(d) > 1)
            if dims:
                groups.setdefault((x.device_mesh, dims), []).append(i)
    for (mesh, dims), idx in groups.items():
        v = torch.stack([sqs[i] for i in idx])
        for d in dims:
            dist.all_reduce(v, group=mesh.get_group(d))
        for j, i in enumerate(idx):
            sqs[i] = v[j]
    return torch.sqrt(sum(sqs))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params: nn.Module,
                  opt_state: Dict[str, object],
                  grads: Sequence[torch.Tensor]
                  ) -> Tuple[nn.Module, Dict[str, object],
                             Dict[str, torch.Tensor]]:
    """One AdamW step from `grads` (in `named_parameters()` order, each a
    DTensor in its parameter's placements where the parameters are), in
    place; returns (params, opt_state, {"grad_norm", "lr"}), the metrics
    plain 0-dim tensors."""
    step = _local(opt_state["step"])
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(gnorm),
                          cfg.clip_norm / torch.clamp_min(gnorm, 1e-9))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** (step.float() + 1.0)
    bc2 = 1.0 - b2 ** (step.float() + 1.0)
    for (name, p), g in zip(params.named_parameters(), grads):
        m, v = _local(opt_state["m"][name]), _local(opt_state["v"][name])
        master = _local(opt_state["master"][name])
        p = _local(p)
        g = _local(g).float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        master.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * master))
        p.copy_(master)
    opt_state["step"] = replicated_step(step + 1, opt_state["step"])
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
