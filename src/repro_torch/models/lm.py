"""Decoder-only LM assembled from blocks.

A port of `repro.models.lm`. The JAX package scans one pattern period
(super-block) per step over stacked params, then runs an explicit
remainder; the port keeps one `Block` module per layer and loops over them
in the same order — the super-blocks' layers, repeat by repeat, then
`rem{r}`. A cache is a list with one entry per layer, in that order.
Positions are `arange(T)` from 0 in prefill even when prompts are
left-padded, exactly as in the JAX package.

Training: `apply(..., mode="train", remat=...)` recomputes each pattern
period in the backward (`torch.utils.checkpoint`, as the JAX package wraps
`superblock_body` in `jax.checkpoint`; the remainder is not recomputed,
there as here). `remat="dots"` recomputes all but the products with no
batch dimension, as `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`
does: a selective checkpoint that saves the outputs of `aten.mm` and
`aten.addmm` (the projections, a `(B, T, D) @ (D, F)` product folded to
2-D) and recomputes the rest, `aten.bmm` and the kernels' autograd
Functions among it. `loss_fn` is the next-token cross-entropy through
`chunked_xent`: on a CUDA tensor the fused cross-entropy kernel
(`kernels/xent`), on a CPU tensor the JAX package's chunked body.

On a device mesh (`parallel/policy.py`, rules set by the train step) the
tokens are this rank's rows, each block gathers its weights at use inside
the recomputed region (so the backward gathers them again, as FSDP with
remat does), the embedding and the head are gathered whole, the xent
kernel runs on the rank's rows and the loss is the global batch's mean.

Under sequence parallelism (rules with `seq_shard`, a model axis wider
than 1, T > 1, in prefill and in training's hidden states) `apply` runs
its blocks in a T-sharded section (`policy.seq_section`): the embedding
looks up the rank's slice of the tokens (T padded to a multiple of the
model size), the blocks carry the slice and `final_norm` runs on it.
Prefill's logits are the whole T's (`policy.seq_gather`, then the head),
so its logits and cache are those of the step without it. `loss_fn`
runs the xent kernel on the rank's slice of the rows and sums the ranks'
partial sums over "model" (`policy.seq_sum`).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import torch
from torch import nn
from contextlib import nullcontext
from functools import partial

from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core import op_cost
from repro_torch.kernels.xent import ops as xent_ops
from repro_torch.models import blocks as B
from repro_torch.parallel import policy
from repro_torch.models.common import (ParamTree, embed_init, norm_apply,
                                       norm_init, torch_dtype)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Every layer's block kind, in the order the forward pass runs them."""
    return (list(cfg.pattern) * cfg.n_repeats
            + [cfg.pattern[r] for r in range(cfg.n_remainder)])


class LM(nn.Module):
    """The model's parameters: the embedding, one `Block` per layer, the
    final norm and (untied) the LM head, all named and laid out as the JAX
    package's (`head` is `(d_model, padded_vocab)`)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 block_params: Sequence[Mapping[str, object]],
                 final_norm: Mapping[str, torch.Tensor],
                 head: Optional[torch.Tensor] = None):
        super().__init__()
        kinds = layer_kinds(cfg)
        if len(block_params) != len(kinds):
            raise ValueError(f"{len(block_params)} blocks for {len(kinds)} "
                             f"layers")
        if cfg.tie_embeddings != (head is None):
            raise ValueError("a tied config takes no head; an untied one "
                             "needs one")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(
            B.Block(kind, cfg, p) for kind, p in zip(kinds, block_params))
        self.final_norm = ParamTree(final_norm)
        self.head = (None if head is None
                     else nn.Parameter(head, requires_grad=False))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> LM:
    """Random parameters from `gen`, on its device."""
    dtype = torch_dtype(cfg.param_dtype)
    blocks = [B.block_init(kind, gen, cfg, dtype) for kind in layer_kinds(cfg)]
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)
    head = None
    if not cfg.tie_embeddings:
        head = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype).T
        head = head.contiguous()
    return LM(cfg, embed, blocks, norm_init(cfg, cfg.d_model, gen.device),
              head)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> list:
    dtype = torch_dtype(cfg.dtype)
    return [B.init_block_cache(kind, cfg, batch, max_len, dtype, device)
            for kind in layer_kinds(cfg)]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _positions(cfg: ModelConfig, b: int, t: int, offset: int,
               device) -> torch.Tensor:
    """(B, T) positions from `offset`; (B, T, 3), the three M-RoPE
    components equal, for an M-RoPE config."""
    pos = (offset + torch.arange(t, device=device)).expand(b, t)
    if cfg.mrope_sections:
        pos = pos[..., None].expand(b, t, 3)
    return pos


REMATS = ("none", "full", "dots")

# the products with no batch dimension, which remat="dots" keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _train_blocks(blocks, x, positions, rules=None):
    """The blocks in order; `rules`: the mesh rules to run them under (a
    recomputation in the backward re-enters the forward's)."""
    aux = 0.0
    with policy.using(rules) if rules is not None else nullcontext():
        for block in blocks:
            x, _, a = block(x, positions=positions, mode="train")
            aux = aux + a
    return x, aux


def _head(cfg: ModelConfig, params: LM, use: str = "full") -> torch.Tensor:
    """The LM head (D, Vp), gathered whole on a mesh (`policy.gather`'s
    `use`)."""
    if cfg.tie_embeddings:
        return policy.gather(params.embed, use).T
    return policy.gather(params.head, use)


def apply(cfg: ModelConfig, params: LM, tokens: Optional[torch.Tensor] = None,
          *, mode: str = "train", cache: Optional[list] = None, pos: int = 0,
          embeddings: Optional[torch.Tensor] = None, remat: str = "full",
          return_hidden: bool = False):
    """Forward pass.

    tokens: (B, T) integer, or `embeddings`: (B, T, D) (the modality
    stubs' input). mode "train": logits only. "prefill": logits + filled
    cache. "decode": T == 1, reads/writes cache at `pos`. `remat`
    ("full", "dots" or "none") applies in train mode with grad enabled:
    each pattern period's activations are recomputed in the backward, all
    of them ("full") or all but the 2-D products' outputs ("dots").
    `return_hidden` skips the LM head (the loss computes it chunk by chunk).
    Returns (logits or hidden, new_cache, aux), aux the sum of the MoE
    layers' load-balancing terms (the number 0.0 without MoE). Under
    sequence parallelism the hidden states are the rank's slice of T
    (`policy.seq_span`; module docstring).
    """
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r}; expected one of {REMATS}")
    inp = policy.batch_local(tokens if embeddings is None else embeddings)
    b, t = inp.shape[:2]
    # train-mode logits stay whole: their gradient is every rank's alike
    sp = ((mode == "prefill" or mode == "train" and return_hidden)
          and policy.seq_shard_on(t))
    with policy.seq_section(t) if sp else nullcontext():
        if embeddings is None:      # under seq_shard the rank's slice
            x = policy.gather(params.embed, "partial" if sp else "full")[
                policy.seq_slice(inp).long()].to(torch_dtype(cfg.dtype))
        else:
            x = policy.seq_scatter(inp.to(torch_dtype(cfg.dtype)))
        positions = _positions(cfg, b, t, pos if mode == "decode" else 0,
                               x.device)
        new_cache = [] if cache is not None else None
        aux = 0.0
        if mode == "train" and remat != "none" and torch.is_grad_enabled():
            period = len(cfg.pattern)
            kw = ({} if remat == "full" else {"context_fn": partial(
                create_selective_checkpoint_contexts, _dots_policy)})
            for r in range(cfg.n_repeats):
                x, a = checkpoint(_train_blocks,
                                  params.blocks[r * period:(r + 1) * period],
                                  x, positions, policy.current(),
                                  use_reentrant=False, **kw)
                aux = aux + a
            x, a = _train_blocks(params.blocks[cfg.n_repeats * period:], x,
                                 positions)
            aux = aux + a
        else:
            for i, block in enumerate(params.blocks):
                c = cache[i] if cache is not None else None
                x, nc, a = block(x, positions=positions, mode=mode, cache=c,
                                 pos=pos)
                aux = aux + a
                if cache is not None:
                    new_cache.append(nc)
        x = norm_apply(cfg, policy.gather_block_weights(params.final_norm),
                       x)
        if return_hidden:
            return x, new_cache, aux
        x = policy.seq_gather(x)
    logits = x @ _head(cfg, params).to(x.dtype)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    logits = mask_padded_vocab(logits, cfg.vocab_size)
    return logits, new_cache, aux


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """-1e30 out the physical padding columns (padded_vocab > vocab_size) so
    sampling never sees them."""
    pv = logits.shape[-1]
    if pv == vocab:
        return logits
    valid = torch.arange(pv, device=logits.device) < vocab
    return torch.where(valid, logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device))


def chunked_xent(hidden: torch.Tensor, head: torch.Tensor,
                 targets: torch.Tensor, chunk: int = 512,
                 softcap: float = 0.0, vocab: int = 0) -> torch.Tensor:
    """Mean next-token NLL without materializing (B, T, V).

    hidden: (B, T, D); targets: (B, T) aligned with hidden; `vocab`: the
    logical vocab size (masks physical padding columns). On a CUDA tensor
    the fused cross-entropy kernel runs (its fp32 product; its backward
    recomputes 512 rows at a time), and on a fake tensor of a dry-run's
    trace its wrapper records the call. On a CPU tensor the JAX package's
    body runs: windows of `chunk` positions, the product in the activation
    dtype, then fp32."""
    if hidden.device.type != "cpu" or op_cost.is_fake(hidden):
        return xent_ops.fused_xent_mean(hidden, head, targets, vocab=vocab,
                                        softcap=softcap)
    b, t, _ = hidden.shape
    w = head.to(hidden.dtype)
    total = torch.zeros((), dtype=torch.float32)
    for i in range(0, t, chunk):
        lg = (hidden[:, i:i + chunk] @ w).float()
        if softcap:
            lg = torch.tanh(lg / softcap) * softcap
        if vocab:
            lg = mask_padded_vocab(lg, vocab)
        logz = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, targets[:, i:i + chunk, None].long())[..., 0]
        total = total + (logz - gold).sum()
    return total / (b * t)


def loss_fn(cfg: ModelConfig, params: LM, batch, remat: str = "full",
            xent_chunk: int = 512) -> torch.Tensor:
    """Next-token cross-entropy (+ the MoE aux term, weighted by
    `cfg.moe.aux_loss_weight`). batch: {"tokens": (B, T)}. Under sequence
    parallelism each model rank runs the xent on its slice of the rows
    (position p's target is token p + 1; the last position has none) and
    the partial sums add over "model" (module docstring)."""
    tokens = policy.batch_local(batch["tokens"])
    hidden, _, aux = apply(cfg, params, tokens, mode="train", remat=remat,
                           return_hidden=True)
    b, t = tokens.shape
    kw = dict(chunk=xent_chunk, softcap=cfg.logit_softcap,
              vocab=cfg.vocab_size)
    if not policy.seq_shard_on(t):
        nll = chunked_xent(hidden[:, :-1], _head(cfg, params), tokens[:, 1:],
                           **kw)
    else:
        lo, tl = policy.seq_span(t)
        n = max(0, min(tl, t - 1 - lo))     # the slice's rows with a target
        head = _head(cfg, params, "partial")
        if n:
            part = chunked_xent(hidden[:, :n], head,
                                tokens[:, lo + 1:lo + 1 + n], **kw) * (b * n)
        else:   # no row: a zero that keeps every collective of the backward
            part = (hidden.float().sum() + head.float().sum()) * 0.0
        nll = policy.seq_sum(part) / (b * (t - 1))
    if cfg.moe:
        nll = nll + cfg.moe.aux_loss_weight * aux
    return policy.batch_mean(nll)


def prefill(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
            max_len: Optional[int] = None):
    """Run the prompt, return (logits, cache ready for decode at pos=T)."""
    b, t = tokens.shape
    cache = init_cache(cfg, b, max_len or t, tokens.device)
    logits, cache, _ = apply(cfg, params, tokens, mode="prefill",
                             cache=cache)
    return logits, cache


def decode_step(cfg: ModelConfig, params: LM, cache: list,
                token: torch.Tensor, pos: int):
    """token: (B, 1) -> (logits (B,1,V), cache). Writes the new token's K/V
    into `cache` in place."""
    logits, cache, _ = apply(cfg, params, token, mode="decode", cache=cache,
                             pos=pos)
    return logits, cache
