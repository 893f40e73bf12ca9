"""GQA attention: chunked flash (memory-efficient) and decode paths.

A port of `repro.models.attention`. `flash_attention` is what every
attention layer runs in prefill: on a CPU tensor it is the JAX package's
chunked online-softmax body in plain PyTorch (q scaled in its own dtype, as
the model scales it); on a CUDA tensor it launches the hand-written flash
kernel (`kernels/flash_attention`, the twin of the TPU serving path's
Pallas kernel, which scales q in fp32) or raises. A fake tensor of a
dry-run's trace takes the kernel's way too, and its wrapper records the
call (`core/op_cost.py`). `decode_attention` and
`dense_attention` (the encoder-decoder's cross-attention) have no kernel in
the reference and stay plain PyTorch. On a device mesh every one of them
runs on a rank's local (batch shard, head shard) tensors
(`parallel/policy.py`).
"""

from __future__ import annotations

import torch

from repro_torch.core import op_cost
from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30


def _mask(qpos, kpos, causal: bool, window: int):
    """(Tq, Tk) boolean validity mask from global positions."""
    d = qpos[:, None] - kpos[None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window:
        m &= d < window
    return m


def dense_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, softcap: float = 0.0):
    """q: (B, T, H, hd); k, v: (B, S, K, hd). Materializes the scores: for
    short T·S (decode, cross-attention over the encoder's frames)."""
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qs = (q * (hd ** -0.5)).reshape(b, t, kh, g, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qs.float(), k.float())
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    qpos = q_offset + torch.arange(t, device=q.device)
    kpos = torch.arange(s, device=q.device)
    scores = torch.where(_mask(qpos, kpos, causal, window), scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", p, v.float())
    return out.reshape(b, t, h, hd).to(q.dtype)


def _divisor_chunk(t: int, chunk: int) -> int:
    """Largest chunk size <= `chunk` that divides t."""
    c = min(chunk, t)
    while t % c:
        c -= 1
    return c


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Online-softmax attention that never materializes (T, S).
    q: (B, T, H, hd); k, v: (B, S, K, hd). On CUDA the kernel picks its own
    blocks."""
    if q.device.type != "cpu" or op_cost.is_fake(q):
        return flash_ops.flash_mha(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return _flash_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap)


def _flash_attention(q, k, v, *, causal, window, softcap,
                     q_chunk: int = 1024, kv_chunk: int = 1024):
    """The JAX package's chunked body (`attention.py:79-140`, with its
    default chunks): every (q_chunk, kv_chunk) block computed with masking,
    in order."""
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    q_chunk = _divisor_chunk(t, q_chunk)
    kv_chunk = _divisor_chunk(s, kv_chunk)
    nq, nk = t // q_chunk, s // kv_chunk

    qs = (q * (hd ** -0.5)).reshape(b, nq, q_chunk, kh, g, hd)
    ks = k.reshape(b, nk, kv_chunk, kh, hd)
    vs = v.reshape(b, nk, kv_chunk, kh, hd)
    dev = q.device
    outs = []
    for qi in range(nq):
        q_blk = qs[:, qi].float()                  # (b, qc, kh, g, hd)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m_run = torch.full((b, kh, g, q_chunk), NEG_INF, device=dev)
        l_run = torch.zeros((b, kh, g, q_chunk), device=dev)
        acc = torch.zeros((b, q_chunk, kh, g, hd), device=dev)
        for ki in range(nk):
            scores = torch.einsum("bqkgh,bskh->bkgqs", q_blk,
                                  ks[:, ki].float())
            if softcap:
                scores = torch.tanh(scores / softcap) * softcap
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            scores = torch.where(_mask(qpos, kpos, causal, window), scores,
                                 NEG_INF)
            m_new = torch.maximum(m_run, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskh->bqkgh", p, vs[:, ki].float())
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m_run = m_new
        l_t = l_run.permute(0, 3, 1, 2)[..., None]
        outs.append(acc / torch.clamp_min(l_t, 1e-37))
    out = torch.stack(outs, dim=1).reshape(b, t, h, hd)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0,
                     softcap: float = 0.0):
    """One-token attention over a cache.

    q: (B, 1, H, hd); caches (B, S, K, hd). `pos` is the index of the token
    being generated (its K/V already written at `pos` — or `pos % S` for
    ring-buffer local caches). Validity: written slots only.
    """
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qs = (q * (hd ** -0.5)).reshape(b, kh, g, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qs.float(), k_cache.float())
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    slot = torch.arange(s, device=q.device)
    if window and pos >= s:
        # ring buffer of size s == window, wrapped: every slot is written
        valid = torch.ones(s, dtype=torch.bool, device=q.device)
    else:
        valid = slot <= pos
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)
