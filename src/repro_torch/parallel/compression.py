"""Gradient compression codecs + compressed cross-replica reductions.

A port of `repro.parallel.compression`. `int8_rowwise` quantizes each row
(last axis) to int8 with a per-row fp32 scale and stochastic rounding
(unbiased); its noise comes from an explicit `torch.Generator`, so it is
not the JAX package's draw. `compressed_psum` reduces a gradient tree
over one axis of a `torch.distributed` `DeviceMesh` (the process group of
that mesh dim): "none" sums in fp32, "bf16" sums bf16 payloads (half the
wire bytes), "int8" sums the int8 payload in int32 (exact) and the
per-row scales, then decodes with the mean scale, as the JAX package
does. `exact_compressed_psum` all-gathers the (q, s) pairs and decodes
each before summing. Each returns the mean over the axis. Plain PyTorch:
the JAX package has no Pallas kernel here either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

METHODS = ("none", "bf16", "int8")


def int8_rowwise_encode(x: torch.Tensor,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 values shaped as x, fp32 scale per row: x.shape[:-1] +
    (1,), or (1, 1) for a vector). A value is rounded up with probability
    its fraction (uniform noise from `generator`)."""
    xf = x.float()
    flat = xf.reshape(-1, xf.shape[-1]) if xf.dim() > 1 else xf.reshape(1, -1)
    scale = flat.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-30)
    y = flat / scale
    noise = torch.rand(y.shape, generator=generator, device=y.device) - 0.5
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    q = q.reshape(x.shape)
    scale_shape = (tuple(x.shape[:-1]) + (1,)) if x.dim() > 1 \
        else tuple(scale.shape)
    return q, scale.reshape(scale_shape)


def int8_rowwise_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _leaves(tree):
    """(flat list of tensors, rebuild(list) -> tree) of a dict / list /
    tuple / tensor tree."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_leaves(tree[k]) for k in keys]
    else:
        keys = None
        parts = [_leaves(v) for v in tree]
    sizes = [len(p[0]) for p in parts]
    flat = [x for p in parts for x in p[0]]

    def rebuild(xs):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(xs[i:i + n]))
            i += n
        return dict(zip(keys, out)) if keys is not None else type(tree)(out)

    return flat, rebuild


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def compressed_psum(tree, mesh, axis: str, method: str = "none",
                    generator: Optional[torch.Generator] = None):
    """The mean of a gradient tree over mesh axis `axis`, each rank
    contributing its own; the wire carries fp32 ("none"), bf16 ("bf16")
    or int8 with a per-row scale ("int8": the summed int8 values decoded
    with the mean scale, unbiased where the ranks' scales are near-equal).
    Every rank returns the same tree of fp32 tensors."""
    if method not in METHODS:
        raise ValueError(f"method {method!r}; expected one of {METHODS}")
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    leaves, rebuild = _leaves(tree)
    out = []
    for g in leaves:
        if method == "none":
            out.append(_sum(g.float(), group) / n)
        elif method == "bf16":
            out.append(_sum(g.to(torch.bfloat16), group).float() / n)
        else:
            q, s = int8_rowwise_encode(g, generator)
            qs = _sum(q.to(torch.int32), group)
            ss = _sum(s, group)                      # sum of row maxima
            out.append(qs.float() * (ss / n) / n)
    return rebuild(out)


def exact_compressed_psum(tree, mesh, axis: str,
                          generator: Optional[torch.Generator] = None):
    """Exact int8 wire compression: all-gather the (q, s) pairs and
    decode-sum (1 byte an element + 4 a row on the wire, against 4 an
    element for fp32). Returns the mean over `axis`."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    leaves, rebuild = _leaves(tree)
    out = []
    for g in leaves:
        q, s = int8_rowwise_encode(g, generator)
        qg = [torch.empty_like(q) for _ in range(n)]
        sg = [torch.empty_like(s) for _ in range(n)]
        dist.all_gather(qg, q.contiguous(), group=group)
        dist.all_gather(sg, s.contiguous(), group=group)
        dec = sum(int8_rowwise_decode(qi, si) for qi, si in zip(qg, sg))
        out.append(dec / n)
    return rebuild(out)
