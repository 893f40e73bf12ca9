"""Feed-forward: gated (SwiGLU/GeGLU) or plain. A port of
`repro.models.mlp` (the MoE FFN is `models/moe.py`).

`jax.nn.gelu` defaults to the tanh approximation, so the port's gelu is
`F.gelu(..., approximate="tanh")`; exact gelu would be a different model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init
from repro_torch.parallel import policy


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTS = {"silu": F.silu, "gelu": gelu, "relu": F.relu}


def mlp_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(gen, d, f, dtype),
         "wo": dense_init(gen, f, d, dtype)}
    if cfg.gated_mlp:
        p["wg"] = dense_init(gen, d, f, dtype)
    return p


def mlp_apply(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    act = ACTS[cfg.act]
    tp = policy.is_tp(cfg, "ffn")               # a rank's ffn columns
    x = policy.enter_layer(x, tp)
    h = x @ params["wi"]
    if cfg.gated_mlp:
        h = act(x @ params["wg"]) * h
    else:
        h = act(h)
    out = h @ params["wo"]
    return policy.leave_layer(out, tp)
