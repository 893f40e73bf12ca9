"""Decoder block assembly: one init/apply pair per block kind, and `Block`,
the module that holds one block's parameters.

A port of `repro.models.blocks`. On a device mesh a block computes on
the weights `parallel/policy.py::gather_block_weights` makes local: a
weight narrower than the config's (a rank's heads, ffn columns, experts or
RG-LRU width) marks a tensor-parallel layer, whose input enters with
`policy.enter_tp` and whose partial output leaves summed over "model"
(`policy.leave_tp`). Under sequence parallelism a block's input is the
rank's slice of T: each layer enters on the whole T and leaves on the
slice (`policy.enter_layer`, `leave_layer`). Kinds: "attn"/"global"
(full causal attention + FFN), "local" (sliding window + FFN), "rec" (RG-LRU + FFN),
"ssd" (Mamba2 mixer, no FFN). The FFN is a MoE layer where the config has
`moe`. Every apply has the signature
    apply(cfg, params, x, *, positions, mode, cache, pos) -> (x, cache', aux)
where mode ∈ {"train", "prefill", "decode"} and `aux` is the MoE layer's
load-balancing term (the number 0.0 without one). A recurrent or SSD block's state is
its cache in decode.

Unlike the JAX package, decode writes the new token's K/V into the cache
in place and returns that same cache (the JAX package returns an updated
copy); prefill builds a new cache, as there.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (ParamTree, dense_init, norm_apply,
                                       norm_init, qk_norm_apply, rope_apply)
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.rglru import (rglru_block_apply, rglru_init,
                                      rglru_init_state)
from repro_torch.models.ssd import ssd_apply, ssd_init, ssd_init_state
from repro_torch.parallel import policy


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {"wq": dense_init(gen, d, nq, dtype),
         "wk": dense_init(gen, d, nkv, dtype),
         "wv": dense_init(gen, d, nkv, dtype),
         "wo": dense_init(gen, nq, d, dtype)}
    if cfg.qk_norm:
        p["q_scale"] = torch.ones(hd, dtype=torch.float32, device=gen.device)
        p["k_scale"] = torch.ones(hd, dtype=torch.float32, device=gen.device)
    return p


def block_init(kind: str, gen: torch.Generator, cfg: ModelConfig, dtype):
    """One block's parameters as a nested dict of tensors on the
    generator's device, named and shaped as the JAX package's."""
    p = {"norm1": norm_init(cfg, cfg.d_model, gen.device)}
    if kind in ("attn", "global", "local"):
        p["attn"] = attn_init(gen, cfg, dtype)
    elif kind == "rec":
        p["rec"] = rglru_init(gen, cfg, dtype)
    elif kind == "ssd":
        p["ssd"] = ssd_init(gen, cfg, dtype)
    else:
        raise ValueError(kind)
    if kind != "ssd":
        p["norm2"] = norm_init(cfg, cfg.d_model, gen.device)
        p["ffn"] = (moe_init(gen, cfg, dtype) if cfg.moe
                    else mlp_init(gen, cfg, dtype))
    if cfg.sandwich_norm:
        p["post1"] = norm_init(cfg, cfg.d_model, gen.device)
        if kind != "ssd":
            p["post2"] = norm_init(cfg, cfg.d_model, gen.device)
    return p


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device):
    if kind in ("attn", "global"):
        s = max_len
    elif kind == "local":
        s = min(cfg.window, max_len)
    elif kind == "rec":
        return rglru_init_state(cfg, batch, dtype, device)
    elif kind == "ssd":
        return ssd_init_state(cfg, batch, dtype, device)
    else:
        raise ValueError(kind)
    shape = (batch, s, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_dtype == "int8":
        sshape = (batch, s, cfg.n_kv_heads)
        zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
        return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                "k_scale": zeros(sshape, torch.float32),
                "v_scale": zeros(sshape, torch.float32)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _kv_quant(x):
    """(B, T, K, hd) -> int8 values + per-(pos, head) absmax scale."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-10)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q, scale, dtype):
    return (q.float() * scale[..., None].float()).to(dtype)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _attention_mixer(kind, cfg: ModelConfig, params, h, *, positions, mode,
                     cache, pos, causal: bool = True):
    tp = policy.is_tp(cfg, "attn")         # a rank's head shard
    h = policy.enter_layer(h, tp)          # the whole T under seq_shard
    b, t, d = h.shape
    hd = cfg.hd
    q = (h @ params["wq"]).reshape(b, t, -1, hd)
    k = (h @ params["wk"]).reshape(b, t, -1, hd)
    v = (h @ params["wv"]).reshape(b, t, -1, hd)
    if cfg.qk_norm:
        q = qk_norm_apply(q, params["q_scale"])
        k = qk_norm_apply(k, params["k_scale"])
    theta = cfg.rope_theta
    if kind == "local" and cfg.rope_theta_local:
        theta = cfg.rope_theta_local
    if theta:                      # theta == 0 -> no rope (whisper backbone)
        q = rope_apply(q, positions, theta, cfg.mrope_sections)
        k = rope_apply(k, positions, theta, cfg.mrope_sections)
    window = cfg.window if kind == "local" else 0

    quant = cfg.kv_dtype == "int8"
    if mode == "decode":
        s = cache["k"].shape[1]
        slot = pos % s if kind == "local" else pos
        if not 0 <= slot <= s - t:
            raise ValueError(f"decode at position {pos}: slot {slot} is past "
                             f"the cache's {s} positions")
        if quant:
            kq, ks = _kv_quant(k)
            vq, vs = _kv_quant(v)
            for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                              ("v_scale", vs)):
                cache[name][:, slot:slot + t] = val
            ck = _kv_dequant(cache["k"], cache["k_scale"], k.dtype)
            cv = _kv_dequant(cache["v"], cache["v_scale"], v.dtype)
        else:
            cache["k"][:, slot:slot + t] = k
            cache["v"][:, slot:slot + t] = v
            ck, cv = cache["k"], cache["v"]
        new_cache = cache
        out = attn_lib.decode_attention(
            q, ck, cv, pos, window=(s if kind == "local" else 0))
    else:
        out = attn_lib.flash_attention(q, k, v, causal=causal,
                                       window=window)
        if mode == "prefill":
            s = cache["k"].shape[1]
            if kind == "local" and t > s:
                # keep the last `window` keys, ring-aligned so that global
                # position p sits at slot p % s.
                start = t - s
                rot = start % s
                kk = torch.roll(k[:, start:], shifts=rot, dims=1)
                vv = torch.roll(v[:, start:], shifts=rot, dims=1)
            else:
                if t > s:
                    raise ValueError(f"prefill of {t} tokens into a cache of "
                                     f"{s} positions")
                kk = F.pad(k, (0, 0, 0, 0, 0, s - t))
                vv = F.pad(v, (0, 0, 0, 0, 0, s - t))
            if quant:
                kq, ks = _kv_quant(kk)
                vq, vs = _kv_quant(vv)
                new_cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
            else:
                new_cache = {"k": kk, "v": vv}
        else:
            new_cache = cache
    out = out.reshape(b, t, -1) @ params["wo"]
    return policy.leave_layer(out, tp), new_cache


def block_apply(kind: str, cfg: ModelConfig, params, x, *, positions, mode,
                cache=None, pos=None, causal: bool = True):
    aux = 0.0          # a tensor only where a MoE layer computes one
    h = norm_apply(cfg, params["norm1"], x)
    if kind in ("attn", "global", "local"):
        mix, new_cache = _attention_mixer(kind, cfg, params["attn"], h,
                                          positions=positions, mode=mode,
                                          cache=cache, pos=pos, causal=causal)
    elif kind in ("rec", "ssd"):
        state = cache if mode == "decode" else None
        apply = rglru_block_apply if kind == "rec" else ssd_apply
        mix, new_state = apply(cfg, params[kind], h, state)
        new_cache = new_state if mode != "train" else cache
    else:
        raise ValueError(kind)
    if cfg.sandwich_norm:
        mix = norm_apply(cfg, params["post1"], mix)
    x = x + mix

    if kind != "ssd":
        h = norm_apply(cfg, params["norm2"], x)
        if cfg.moe:
            ff, aux = moe_apply(cfg, params["ffn"], h)
        else:
            ff = mlp_apply(cfg, params["ffn"], h)
        if cfg.sandwich_norm:
            ff = norm_apply(cfg, params["post2"], ff)
        x = x + ff
    return x, new_cache, aux


class Block(nn.Module):
    """One decoder block: its kind and its parameters (a `ParamTree` named
    as the JAX package's block params; an encoder-decoder's decoder block
    also holds its cross-attention's `xattn` and `norm_x`)."""

    def __init__(self, kind: str, cfg: ModelConfig,
                 params: Mapping[str, object]):
        super().__init__()
        self.kind = kind
        self.cfg = cfg
        self.params = ParamTree(params)

    def forward(self, x, *, positions, mode, cache=None, pos=None,
                causal: bool = True):
        params = policy.gather_block_weights(self.params, self.cfg)
        return block_apply(self.kind, self.cfg, params, x,
                           positions=positions, mode=mode, cache=cache,
                           pos=pos, causal=causal)
