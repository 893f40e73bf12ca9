"""RG-LRU recurrent block (Griffin / RecurrentGemma).

A port of `repro.models.rglru`. The recurrence h_t = a_t h_{t-1} +
sqrt(1-a_t^2) (i_t x_t) is NERO's "sequential in depth, parallel across
columns" sweep on the time axis. `lru_scan` folds a carried state into the
first step, then runs the sweep on the (B, T, W) layout: on a CPU tensor the
plain log-depth scan, on a CUDA tensor the hand-written LRU kernel
(`kernels/lru_scan`), in prefill and in decode (T = 1) alike.

On a device mesh the block runs on a rank's width shard: the branch
projections, the conv, the gates' columns, Λ and the LRU sweep are its
own, the gates read the whole width (`policy.gather_model`) and `w_out`'s
partial product is summed over "model".

`jax.nn.softplus` is `log1p(exp(-|x|)) + max(x, 0)` and `jax.nn.gelu`
the tanh approximation; the port computes both so.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.models.common import dense_init, normal
from repro_torch.models.mlp import gelu
from repro_torch.parallel import policy


def rglru_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    w = cfg.rec.rnn_width or d
    cw = cfg.rec.conv_width
    return {
        "w_branch_x": dense_init(gen, d, w, dtype),
        "w_branch_g": dense_init(gen, d, w, dtype),
        "conv": normal(gen, (cw, w), 1.0 / cw, dtype),
        "w_rec_gate": dense_init(gen, w, w, dtype),
        "w_in_gate": dense_init(gen, w, w, dtype),
        # Λ init so a^(1/c) ∈ (0.9, 0.999) as in Griffin
        "lam": torch.linspace(2.0, 6.0, w, dtype=torch.float32,
                              device=gen.device),
        "w_out": dense_init(gen, w, d, dtype),
    }


def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, T, W); kernel: (cw, W).
    With `state` (B, cw-1, W) does streaming conv and returns new state."""
    cw = kernel.shape[0]
    if state is None:
        pad = torch.zeros_like(x[:, :cw - 1])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, T+cw-1, W)
    t = x.shape[1]
    out = xp[:, 0:t] * kernel[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + t] * kernel[i]
    # a copy, so a cache does not keep the whole (B, T+cw-1, W) input alive
    new_state = (xp[:, -(cw - 1):].clone() if cw > 1
                 else torch.zeros_like(x[:, :0]))
    return out, new_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: no linear branch above a threshold."""
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp_min(x, 0.0)


def _gates(params, x, x_whole=None):
    """a_t (decay) and gated input for the LRU, fp32. On a mesh `x` is a
    rank's width shard and `x_whole` the whole width the gates read."""
    xf = x.float()
    xw = xf if x_whole is None else x_whole.float()
    r = torch.sigmoid(xw @ params["w_rec_gate"].float())
    i = torch.sigmoid(xw @ params["w_in_gate"].float())
    c = 8.0
    log_a = -c * softplus(params["lam"]) * r
    a = torch.exp(log_a)
    gated_x = i * xf
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * gated_x
    return a, b


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 of (B, T, W)."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return lru_ops.lru_scan(a.contiguous(), b.contiguous())


def rglru_block_apply(cfg: ModelConfig, params, x: torch.Tensor,
                      state: Optional[dict] = None):
    """Griffin recurrent block. x: (B, T, D).

    state (decode): {"h": (B, W) fp32, "conv": (B, cw-1, W)}.
    Returns (out, new_state)."""
    tp = policy.is_tp(cfg, "rec")          # a rank's width shard
    x = policy.enter_layer(x, tp)
    xb = x @ params["w_branch_x"]
    gb = gelu(x @ params["w_branch_g"])
    conv_state = state["conv"] if state is not None else None
    xb, new_conv = causal_conv1d(xb, params["conv"], conv_state)
    a, b = _gates(params, xb, policy.gather_model(xb) if tp else None)
    h0 = state["h"] if state is not None else None
    h = lru_scan(a, b, h0)
    out = (h.to(x.dtype) * gb) @ params["w_out"]
    new_state = {"h": h[:, -1].clone(), "conv": new_conv}
    return policy.leave_layer(out, tp), new_state


def rglru_init_state(cfg: ModelConfig, batch: int, dtype, device):
    w = cfg.rec.rnn_width or cfg.d_model
    cw = cfg.rec.conv_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cw - 1, w), dtype=dtype,
                                device=device)}
