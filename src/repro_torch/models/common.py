"""Shared model primitives: norms, RoPE (with M-RoPE), init helpers and
the parameter tree.

A port of `repro.models.common`. Parameters keep the JAX package's names,
shapes, layouts and dtypes: a dense weight is `(d_in, d_out)` and a layer
computes `x @ w`; norm scales are float32. Random initialisation draws from
a `torch.Generator` on the device the parameters live on, so its numbers
are not the JAX package's (`models/convert.py` carries those across).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each tensor leaf becomes a
    parameter, each dict a child `ParamTree`. `tree["wq"]` reads it as the
    JAX package reads its param dicts. Parameters are made without gradient
    (serving runs under `torch.inference_mode()`); training turns it on
    with `requires_grad_()` (`train/loop.py`)."""

    def __init__(self, tree: Mapping[str, object]):
        super().__init__()
        self._names = []
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            self._names.append(name)

    def __getitem__(self, name: str):
        if name not in self._names:
            raise KeyError(name)
        return getattr(self, name)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("float32" or "bfloat16") as a torch dtype."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r}; expected one of {tuple(DTYPES)}")
    return DTYPES[name]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, d: int, device) -> Dict[str, torch.Tensor]:
    if cfg.norm == "rms":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "ln":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device),
                "bias": torch.zeros(d, dtype=torch.float32, device=device)}
    if cfg.norm == "ln_nonparam":      # OLMo: non-parametric LayerNorm
        return {}
    raise ValueError(cfg.norm)


def norm_apply(cfg: ModelConfig, params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    if cfg.norm == "rms":
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        x = x * params["scale"]
    else:
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + eps)
        if cfg.norm == "ln":
            x = x * params["scale"] + params["bias"]
    return x.to(dt)


def qk_norm_apply(q: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm on q/k (gemma3)."""
    dt = q.dtype
    q = q.float()
    q = q * torch.rsqrt(torch.mean(q * q, dim=-1, keepdim=True) + eps)
    return (q * scale).to(dt)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) int or (B, T, 3) for M-RoPE.

    Half-split (llama-style) rotation in float32. With `mrope_sections`
    (a, b, c), a + b + c == hd/2, frequency i uses position component
    0/1/2 by section (Qwen2-VL M-RoPE; for text inputs the three
    components coincide)."""
    b, t, h, hd = x.shape
    half = hd // 2
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half))
    if positions.dim() == 2:
        angles = positions[..., None].float() * inv_freq      # (B, T, half)
    else:
        if mrope_sections is None:
            raise ValueError("(B, T, 3) positions need mrope_sections")
        sel = torch.cat([torch.full((s,), i, dtype=torch.long,
                                    device=x.device)
                         for i, s in enumerate(mrope_sections)])  # (half,)
        angles = positions.float()[..., sel] * inv_freq       # (B, T, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a generator where parameters are made on the meta
    device: shapes and dtypes only (`Model.param_shapes`)."""
    device = torch.device("meta")


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """`std · N(0, 1)` drawn in float32 on the generator's device, then
    cast to `dtype`."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype) -> torch.Tensor:
    return normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype)
