"""Architecture registry: --arch <id> -> ModelConfig, plus reduced configs
for CPU smoke tests. A copy of the JAX package's registry: the same ten
architectures, so `ARCH_IDS` is the same tuple."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (EncDecConfig, ModelConfig,
                                      MoEConfig, RecurrentConfig, SSDConfig,
                                      SHAPES, ShapeConfig)

from repro_torch.configs.yi_34b import CONFIG as _yi
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama
from repro_torch.configs.gemma3_27b import CONFIG as _gemma3
from repro_torch.configs.granite_moe_3b import CONFIG as _granite
from repro_torch.configs.moonshot_v1_16b import CONFIG as _moonshot
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.qwen2_vl_72b import CONFIG as _qwen2vl

REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in (
    _yi, _olmo, _tinyllama, _gemma3, _granite, _moonshot, _rgemma,
    _whisper, _mamba2, _qwen2vl)}

ARCH_IDS = tuple(sorted(REGISTRY))


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def skips(cfg: ModelConfig, shape_name: str) -> str | None:
    for s, why in cfg.skip_shapes:
        if s == shape_name:
            return why
    return None


def reduced_config(cfg: ModelConfig, layers: int = 0) -> ModelConfig:
    """Small same-family config for CPU smoke tests: few layers (at least
    one full pattern period + remainder), narrow width, tiny vocab/experts."""
    period = len(cfg.pattern)
    n_layers = layers or (period + min(period, 2))
    d_model = 64
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, n_heads) if cfg.n_kv_heads > 1 else 1
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=max(1, min(n_kv, 2)), head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        window=16,
    )
    if cfg.mrope_sections:
        kw["mrope_sections"] = (2, 3, 3)     # sums to head_dim/2 = 8
    if cfg.moe:
        kw["moe"] = MoEConfig(n_experts=4, top_k=2, router_chunk=64)
    if cfg.ssd:
        kw["ssd"] = SSDConfig(d_state=16, head_dim=16, expand=2, chunk=16,
                              conv_width=4, n_groups=1)
    if cfg.rec:
        kw["rec"] = RecurrentConfig(rnn_width=64, conv_width=4)
    if cfg.encdec:
        kw["encdec"] = EncDecConfig(encoder_layers=2, encoder_len=32)
        kw["n_layers"] = 2
    return dataclasses.replace(cfg, **kw)
