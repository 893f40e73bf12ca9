"""Unified model API: one `Model` facade per configuration.

    model = build(cfg)                                  # device="cuda"
    params = model.init(torch.Generator("cuda").manual_seed(0))
    loss   = model.loss(params, batch)
    logits, cache = model.prefill(params, batch, max_len)
    logits, cache = model.decode_step(params, cache, token, pos)

A port of `repro.models.api` for all ten configurations: the decoder-only
LMs (dense, MoE, RG-LRU, Mamba2 SSD, M-RoPE; `models/lm.py`) and the
encoder-decoder (`models/encdec.py`, `family == "encdec"`), whose batches
carry `frames` beside `tokens` and whose cache carries the encoder's
states as `enc`. It runs on the card unless the caller asks for the CPU:
`build(cfg)` raises where no GPU is present, and `build(cfg,
device="cpu")` runs the plain versions of the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models.common import MetaGenerator, torch_dtype
from repro_torch.parallel import policy

Params = Union[lm.LM, encdec.EncDec]


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

    @property
    def family(self) -> str:
        return "encdec" if self.cfg.encdec else "lm"

    # ---- params -----------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Random parameters from `generator`, which must live on the
        model's device."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}; the model "
                             f"runs on {self.device}")
        if self.family == "encdec":
            return encdec.init_params(self.cfg, generator)
        return lm.init_params(self.cfg, generator)

    def param_shapes(self) -> Params:
        """The parameters' names, shapes and dtypes, as a module of meta
        tensors (the JAX package's `param_shapes`)."""
        if self.family == "encdec":
            return encdec.init_params(self.cfg, MetaGenerator())
        return lm.init_params(self.cfg, MetaGenerator())

    # ---- training ---------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             remat: str = "full") -> torch.Tensor:
        """The mean loss over the batch. With DTensor parameters
        (`parallel/sharding.py::distribute`) and a DTensor batch, the
        global batch's mean on every rank (`parallel/policy.py`)."""
        with policy.rules_for(params, batch):
            if self.family == "encdec":
                return encdec.loss_fn(self.cfg, params, batch, remat=remat)
            return lm.loss_fn(self.cfg, params, batch, remat=remat)

    def batch_spec(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        """One training batch's shapes and dtypes, as tensors on the meta
        device (the JAX package's ShapeDtypeStructs)."""
        spec = {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                      device="meta")}
        if self.family == "encdec":
            spec["frames"] = torch.empty(
                (batch, self.cfg.encdec.encoder_len, self.cfg.d_model),
                dtype=torch_dtype(self.cfg.dtype), device="meta")
        return spec

    # ---- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int):
        if self.family == "encdec":
            cache = encdec.init_cache(self.cfg, batch, max_len, self.device)
            cache["enc"] = torch.zeros(
                (batch, self.cfg.encdec.encoder_len, self.cfg.d_model),
                dtype=torch_dtype(self.cfg.dtype), device=self.device)
            return cache
        return lm.init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None):
        """The prompt's logits and a cache ready to decode at its end. On
        a device mesh (rules set, `parallel/policy.py`) a batch DTensor is
        this rank's rows first, so the cache is the rank's."""
        tokens = policy.batch_local(batch["tokens"])
        if self.family == "encdec":
            enc = encdec.encode(self.cfg, params, batch["frames"])
            cache = encdec.init_cache(self.cfg, tokens.shape[0],
                                      max_len or tokens.shape[1],
                                      tokens.device)
            logits, cache = encdec.decode(self.cfg, params, tokens, enc,
                                          mode="prefill", cache=cache)
            return logits, {"dec": cache["dec"], "enc": enc}
        return lm.prefill(self.cfg, params, tokens, max_len)

    def decode_step(self, params: Params, cache, token: torch.Tensor,
                    pos: int, frames_enc: Optional[torch.Tensor] = None):
        """token: (B, 1) -> (logits (B, 1, V), cache). Writes the token's
        K/V into `cache` in place; an encoder-decoder's `enc` is read,
        never written. `frames_enc` (B, F, D), an encoder-decoder's
        encoder output, stands in for `cache["enc"]` and is the returned
        cache's `enc`."""
        if self.family == "encdec":
            enc = cache["enc"] if frames_enc is None else frames_enc
            logits, new = encdec.decode(self.cfg, params, token, enc,
                                        mode="decode",
                                        cache={"dec": cache["dec"]}, pos=pos)
            return logits, {"dec": new["dec"], "enc": enc}
        return lm.decode_step(self.cfg, params, cache, token, pos)


def build(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device_of(device))
