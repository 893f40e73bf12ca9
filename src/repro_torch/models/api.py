"""Unified model API: one `Model` facade per configuration.

    model = build(cfg)                                  # device="cuda"
    params = model.init(torch.Generator("cuda").manual_seed(0))
    loss   = model.loss(params, {"tokens": tokens})
    logits, cache = model.prefill(params, {"tokens": tokens}, max_len)
    logits, cache = model.decode_step(params, cache, token, pos)

A port of `repro.models.api` for the decoder-only LMs. It runs on the card
unless the caller asks for the CPU: `build(cfg)` raises where no GPU is
present, and `build(cfg, device="cpu")` runs the plain versions of the
kernels. MoE, SSD, encoder-decoder and M-RoPE configurations raise
`NotImplementedError` (ROADMAP.md, queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.blocks import UNPORTED


def unported_features(cfg: ModelConfig):
    """The features of `cfg` the port does not run yet."""
    return [name for name, on in (
        ("moe", cfg.moe), ("ssd", cfg.ssd or "ssd" in cfg.pattern),
        ("encdec", cfg.encdec), ("mrope_sections", cfg.mrope_sections))
        if on]


def device_of(device) -> torch.device:
    """`device` as a torch device; a CUDA device must be present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "false: no GPU here (pass device='cpu' for the "
                           "plain versions)")
    return device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    def init(self, generator: torch.Generator) -> lm.LM:
        """Random parameters from `generator`, which must live on the
        model's device."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}; the model "
                             f"runs on {self.device}")
        return lm.init_params(self.cfg, generator)

    def loss(self, params: lm.LM, batch: Dict[str, torch.Tensor],
             remat: str = "full") -> torch.Tensor:
        return lm.loss_fn(self.cfg, params, batch, remat=remat)

    def init_cache(self, batch: int, max_len: int) -> list:
        return lm.init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params: lm.LM, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None):
        return lm.prefill(self.cfg, params, batch["tokens"], max_len)

    def decode_step(self, params: lm.LM, cache: list, token: torch.Tensor,
                    pos: int):
        return lm.decode_step(self.cfg, params, cache, token, pos)


def build(cfg: ModelConfig, device="cuda") -> Model:
    missing = unported_features(cfg)
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} "
                                  f"{UNPORTED}")
    return Model(cfg, device_of(device))
