"""Whisper-style encoder-decoder backbone (the conv audio frontend is a
stub: inputs are precomputed frame embeddings).

A port of `repro.models.encdec`. Encoder: bidirectional attention blocks
over the frames (+ sinusoidal positions); on a CUDA tensor their
self-attention is the flash kernel with `causal=False`. Decoder: causal
self-attention + cross-attention over the encoder's states + FFN. The
JAX package scans stacked layers; the port holds one `Block` a layer
(`EncDec`) and loops over them in order. Cross-attention is
`attention.dense_attention` (no kernel in the reference either); its keys
and values are recomputed from the encoder's states each call, as there.

A cache is {"dec": one self-attention cache a decoder layer}; decode
writes the new token's K/V into it in place, as the port's blocks do.
Positions are sinusoidal absolute embeddings; the whisper config turns
RoPE off with rope_theta=0. On a device mesh the blocks, the
cross-attention's heads and the loss follow `models/lm.py`'s seams.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as B
from repro_torch.models.common import (ParamTree, embed_init, norm_apply,
                                       norm_init, torch_dtype)
from repro_torch.models.lm import chunked_xent, mask_padded_vocab
from repro_torch.parallel import policy


class EncDec(nn.Module):
    """The parameters, named and laid out as the JAX package's: the
    embedding, one `Block` an encoder layer, `enc_norm`, one `Block` a
    decoder layer (each also holding its cross-attention's `xattn` and
    `norm_x`), the final norm and the untied head `(d_model,
    padded_vocab)`."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 enc_blocks: Sequence[Mapping[str, object]],
                 enc_norm: Mapping[str, torch.Tensor],
                 dec_blocks: Sequence[Mapping[str, object]],
                 final_norm: Mapping[str, torch.Tensor],
                 head: torch.Tensor):
        super().__init__()
        if len(enc_blocks) != cfg.encdec.encoder_layers:
            raise ValueError(f"{len(enc_blocks)} encoder blocks for "
                             f"{cfg.encdec.encoder_layers} layers")
        if len(dec_blocks) != cfg.n_layers:
            raise ValueError(f"{len(dec_blocks)} decoder blocks for "
                             f"{cfg.n_layers} layers")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.enc_blocks = nn.ModuleList(B.Block("attn", cfg, p)
                                        for p in enc_blocks)
        self.enc_norm = ParamTree(enc_norm)
        self.dec_blocks = nn.ModuleList(B.Block("attn", cfg, p)
                                        for p in dec_blocks)
        self.final_norm = ParamTree(final_norm)
        self.head = nn.Parameter(head, requires_grad=False)


def sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions: (B, T) -> (B, T, d) sinusoidal embedding, float32."""
    pos = positions.float()[..., None]
    i = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> EncDec:
    """Random parameters from `gen`, on its device, a layer at a time."""
    dtype = torch_dtype(cfg.param_dtype)
    dev = gen.device
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)
    enc = [B.block_init("attn", gen, cfg, dtype)
           for _ in range(cfg.encdec.encoder_layers)]
    dec = []
    for _ in range(cfg.n_layers):
        p = B.block_init("attn", gen, cfg, dtype)
        p["xattn"] = B.attn_init(gen, cfg, dtype)
        p["norm_x"] = norm_init(cfg, cfg.d_model, dev)
        dec.append(p)
    head = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype).T
    return EncDec(cfg, embed, enc, norm_init(cfg, cfg.d_model, dev), dec,
                  norm_init(cfg, cfg.d_model, dev), head.contiguous())


def encode(cfg: ModelConfig, params: EncDec,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, D) stub conv-frontend output -> encoder states."""
    frames = policy.batch_local(frames)
    b, f, d = frames.shape
    dtype = torch_dtype(cfg.dtype)
    positions = torch.arange(f, device=frames.device).expand(b, f)
    x = frames.to(dtype) + sinusoid_at(positions, d).to(dtype)
    for block in params.enc_blocks:
        x, _, _ = block(x, positions=positions,
                        mode="train", causal=False)
    return norm_apply(cfg, policy.gather_block_weights(params.enc_norm), x)


def _cross_attend(cfg: ModelConfig, p_blk, x, enc):
    b, t, d = x.shape
    f = enc.shape[1]
    hd = cfg.hd
    h = norm_apply(cfg, p_blk["norm_x"], x)
    w = p_blk["xattn"]
    tp = policy.is_tp(cfg, "xattn")                 # a rank's head shard
    if tp:
        h, enc = policy.enter_tp(h), policy.enter_tp(enc)
    q = (h @ w["wq"]).reshape(b, t, -1, hd)
    k = (enc @ w["wk"]).reshape(b, f, -1, hd)
    v = (enc @ w["wv"]).reshape(b, f, -1, hd)
    out = attn_lib.dense_attention(q, k, v, causal=False)
    out = out.reshape(b, t, -1) @ w["wo"]
    return x + (policy.leave_tp(out) if tp else out)


def decode(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor,
           enc: torch.Tensor, *, mode: str = "train",
           cache: Optional[dict] = None, pos: int = 0,
           return_hidden: bool = False):
    """Decoder forward. tokens (B, T); enc (B, F, D). Returns (logits or
    hidden, new_cache); in decode the cache's K/V are written in place."""
    tokens = policy.batch_local(tokens)
    b, t = tokens.shape
    offset = pos if mode == "decode" else 0
    positions = (offset + torch.arange(t, device=tokens.device)).expand(b, t)
    dtype = torch_dtype(cfg.dtype)
    x = (policy.gather(params.embed)[tokens.long()].to(dtype)
         + sinusoid_at(positions, cfg.d_model).to(dtype))
    new_dec = []
    for i, block in enumerate(params.dec_blocks):
        c = cache["dec"][i] if cache is not None else None
        p = policy.gather_block_weights(block.params, cfg)
        x, nc, _ = B.block_apply("attn", cfg, p, x,
                                 positions=positions, mode=mode, cache=c,
                                 pos=pos)
        x = _cross_attend(cfg, p, x, enc)
        new_dec.append(nc)
    x = norm_apply(cfg, policy.gather_block_weights(params.final_norm), x)
    new_cache = {"dec": new_dec} if cache is not None else None
    if return_hidden:
        return x, new_cache
    logits = mask_padded_vocab(x @ policy.gather(params.head).to(x.dtype),
                               cfg.vocab_size)
    return logits, new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    dtype = torch_dtype(cfg.dtype)
    return {"dec": [B.init_block_cache("attn", cfg, batch, max_len, dtype,
                                       device)
                    for _ in range(cfg.n_layers)]}


def loss_fn(cfg: ModelConfig, params: EncDec, batch, remat: str = "full",
            xent_chunk: int = 512) -> torch.Tensor:
    """batch: {"tokens": (B, T), "frames": (B, F, D)}. `remat` is taken
    and, as in the JAX package, not applied: nothing is recomputed."""
    enc = encode(cfg, params, batch["frames"])
    tokens = policy.batch_local(batch["tokens"])
    hidden, _ = decode(cfg, params, tokens, enc, mode="train",
                       return_hidden=True)
    return policy.batch_mean(chunked_xent(
        hidden[:, :-1], policy.gather(params.head), tokens[:, 1:],
        chunk=xent_chunk, vocab=cfg.vocab_size))
