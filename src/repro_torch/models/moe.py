"""Mixture-of-Experts: top-k routing with chunked GShard capacity dispatch.

A port of `repro.models.moe`. Tokens are routed in chunks of
`router_chunk` (the JAX package's `lax.map` over chunks is a loop here);
capacity per chunk C = ceil(chunk·k/E · capacity_factor), rounded up to a
multiple of 4. A (token, choice) pair's place in its expert's queue is the
token-major running count of earlier pairs routed there, so which tokens
overflow (and drop to the residual path) depends on token order inside a
chunk, as in the JAX package. Top-k is a stable descending sort of the
softmax: equal probabilities go to the lower expert first, as
`jax.lax.top_k` breaks ties (`torch.topk` promises no order for ties on
CUDA).

Two dispatches, as there: `impl="onehot"` (the GShard one-hot einsums, the
default) and `"gather"` (slot -> token indices, a gather into the expert
queues and one back). The router runs in float32; the expert products are
`torch.bmm` over the stacked experts (the JAX package computes them outside
any Pallas kernel too). Routing and dispatch run under the profiler label
`moe_dispatch`, the combine under `moe_combine` (`core/spans.py::span`,
recorded only while a profiler records).

Returns the Switch load-balancing auxiliary loss, from the first choice
only, beside the output.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.spans import span
from repro_torch.models.common import dense_init
from repro_torch.models.mlp import ACTS
from repro_torch.parallel import policy


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    """The router (float32, (D, E)) and `wi`/`wo` (and `wg` if gated)
    stacked over experts, each expert drawn in float32 and cast on its
    own, so no float32 copy of a whole stack exists."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts

    def stack(d_in, d_out):
        out = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
        for i in range(e):
            out[i] = dense_init(gen, d_in, d_out, dtype)
        return out

    p = {"router": dense_init(gen, d, e, torch.float32),
         "wi": stack(d, f), "wo": stack(f, d)}
    if cfg.gated_mlp:
        p["wg"] = stack(d, f)
    return p


def _capacity(chunk: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(chunk * m.top_k / m.n_experts * m.capacity_factor)
    return max(4, -(-c // 4) * 4)   # round up to multiple of 4


def _route(cfg: ModelConfig, params, xs: torch.Tensor, cap: int):
    """Router -> top-k gates (renormalised), expert indices, queue
    positions, the pairs that fit (`pos < cap`) and the aux term."""
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    chunk = xs.shape[0]
    probs = torch.softmax(xs.float() @ params["router"], dim=-1)  # (chunk, E)
    gate_idx = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[:, :k]             # (chunk, k)
    gate_vals = probs.gather(-1, gate_idx)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    # position of each (token, slot) within its expert queue
    flat = F.one_hot(gate_idx, e).reshape(chunk * k, e)
    pos_in_e = torch.cumsum(flat, dim=0) - flat
    pos = (pos_in_e * flat).sum(-1).reshape(chunk, k)
    keep = pos < cap
    # Switch aux loss: fraction routed vs mean prob per expert.
    me = probs.mean(dim=0)                                        # (E,)
    ce = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)
    return gate_vals, gate_idx, pos, keep, aux


def _experts(cfg: ModelConfig, params, xe: torch.Tensor) -> torch.Tensor:
    """(E, cap, d) -> (E, cap, d) expert FFN. On a mesh a rank holds its
    experts (expert-parallel) or every expert's d_ff shard; its output,
    zero outside its experts or a partial sum over d_ff, is summed over
    "model", so the combine sees every expert's output."""
    act = ACTS[cfg.act]
    e, e_loc = cfg.moe.n_experts, params["wi"].shape[0]
    tp = policy.is_tp(cfg, "moe")
    if tp:
        xe = policy.enter_tp(xe)
        r = policy.model_rank()
        if e_loc != e:
            xe = xe[r * e_loc:(r + 1) * e_loc]
    h = torch.bmm(xe, params["wi"])
    if cfg.gated_mlp:
        h = act(torch.bmm(xe, params["wg"])) * h
    else:
        h = act(h)
    y = torch.bmm(h, params["wo"])
    if not tp:
        return y
    if e_loc != e:
        y = F.pad(y, (0, 0, 0, 0, r * e_loc, e - (r + 1) * e_loc))
    return policy.leave_tp(y)


def _route_onehot(cfg: ModelConfig, params, xs: torch.Tensor, cap: int):
    """GShard dispatch: dense (chunk, k, E, cap) one-hot combine tensors."""
    e, dt = cfg.moe.n_experts, xs.dtype
    with span("moe_dispatch"):
        gate_vals, gate_idx, pos, keep, aux = _route(cfg, params, xs, cap)
        # a position past the queue is kept out by `keep`, as JAX's
        # one_hot gives it a zero row
        disp = (F.one_hot(gate_idx, e).to(dt)[..., None]
                * F.one_hot(pos.clamp(max=cap - 1), cap).to(dt)[..., None, :])
        disp = disp * keep[..., None, None].to(dt)            # (chunk,k,E,cap)
        xe = torch.einsum("td,tkec->ecd", xs, disp)           # (E,cap,d)
    ye = _experts(cfg, params, xe)
    with span("moe_combine"):
        comb = disp * gate_vals[..., None, None].to(dt)
        y = torch.einsum("ecd,tkec->td", ye, comb)            # (chunk,d)
    return y, aux


def _route_gather(cfg: ModelConfig, params, xs: torch.Tensor, cap: int):
    """Slot -> token indices, a gather into the expert queues, and a
    gather back: O(E·cap·d + chunk·k·d) traffic instead of the one-hot
    tensor. Overflowing pairs write to a spare column past the queue,
    which is dropped (the JAX package's `mode="drop"`)."""
    e, k, dt = cfg.moe.n_experts, cfg.moe.top_k, xs.dtype
    chunk = xs.shape[0]
    with span("moe_dispatch"):
        gate_vals, gate_idx, pos, keep, aux = _route(cfg, params, xs, cap)
        pos_w = pos.clamp(max=cap)
        tok_ids = torch.arange(chunk, device=xs.device)[:, None].expand(
            chunk, k)
        slot_tok = torch.zeros((e, cap + 1), dtype=torch.long,
                               device=xs.device)
        slot_tok[gate_idx, pos_w] = tok_ids
        slot_ok = torch.zeros((e, cap + 1), dtype=torch.bool,
                              device=xs.device)
        slot_ok[gate_idx, pos_w] = True
        slot_tok, slot_ok = slot_tok[:, :cap], slot_ok[:, :cap]
        xe = xs[slot_tok] * slot_ok[..., None].to(dt)         # (E,cap,d)
    ye = _experts(cfg, params, xe)
    with span("moe_combine"):
        back = ye[gate_idx, pos.clamp(max=cap - 1)]           # (chunk,k,d)
        w = (gate_vals * keep).to(dt)
        y = (back * w[..., None]).sum(dim=1)                  # (chunk,d)
    return y, aux


def moe_apply(cfg: ModelConfig, params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out, aux_loss). On a mesh the chunks are the global
    batch's: where this rank's rows do not end on a chunk boundary, the
    rows of every data shard are gathered, routed together and this rank's
    rows kept (`policy.gather_batch`). Under sequence parallelism the
    rank's slice of T is gathered whole first, so the chunks, capacity and
    aux term are the whole sequences' (`policy.seq_whole`)."""
    if policy.seq_on():
        xw = policy.seq_gather(x)
        with policy.seq_whole():
            y, aux = moe_apply(cfg, params, xw)
        return policy.seq_slice(y), policy.seq_partial(aux)
    b, t, d = x.shape
    n = policy.batch_shards()
    chunk = min(cfg.moe.router_chunk, n * b * t)
    if n > 1 and (b * t) % chunk:
        xg = policy.gather_batch(x)
        y, aux = _moe_tokens(cfg, params, xg.reshape(n * b * t, d), chunk)
        y = policy.local_rows(y.reshape(n * b, t, d), b)
        return y.to(x.dtype), aux
    y, aux = _moe_tokens(cfg, params, x.reshape(b * t, d), chunk)
    return y.reshape(b, t, d).to(x.dtype), aux


def _moe_tokens(cfg: ModelConfig, params, xt: torch.Tensor, chunk: int):
    """(N, D) tokens routed in chunks of `chunk` -> ((N, D), aux)."""
    m = cfg.moe
    n_tok = xt.shape[0]
    pad = (-n_tok) % chunk
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    cap = _capacity(chunk, cfg)
    route = _route_gather if m.impl == "gather" else _route_onehot
    ys, auxs = [], []
    for xs in xt.split(chunk):
        y, aux = route(cfg, params, xs, cap)
        ys.append(y)
        auxs.append(aux)
    return torch.cat(ys)[:n_tok], torch.stack(auxs).mean()
