"""Carry an LM's parameters across from the JAX package, via numpy.

`params_from_numpy` takes the JAX package's param pytree
(`repro.models.api.build(cfg).init(key)`) with every leaf as a numpy array
and returns the port's `LM`. The stacked `superblocks` are unstacked along
their leading `n_repeats` axis into one block per layer, in the order the
forward pass runs them; every leaf keeps its layout (`(d_in, d_out)`
weights, so the port's `x @ w` has the JAX package's shapes) and its dtype
(norm scales and `lam` stay float32). bfloat16 crosses as a `uint16` view
of its bits (or as numpy's `bfloat16`), as in `weather/convert.py`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.weather.convert import tensor_from_numpy


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    t = tensor_from_numpy(a, "cpu")
    if t.dtype == torch.uint16:       # no parameter is an integer: bf16 bits
        t = t.view(torch.bfloat16)
    return t.to(device)


def _tree(tree: Mapping, device, index=None):
    """Nested dicts of arrays -> of tensors; `index` takes one slice of
    the leading axis of every leaf."""
    return {k: (_tree(v, device, index) if isinstance(v, Mapping)
                else _tensor(v if index is None else v[index], device))
            for k, v in tree.items()}


def params_from_numpy(cfg: ModelConfig, tree: Mapping, device) -> lm.LM:
    """The JAX package's LM params (numpy leaves) as the port's `LM` on
    `device`."""
    blocks = []
    for rep in range(cfg.n_repeats):
        for i in range(len(cfg.pattern)):
            blocks.append(_tree(tree["superblocks"][f"b{i}"], device, rep))
    for r in range(cfg.n_remainder):
        blocks.append(_tree(tree[f"rem{r}"], device))
    head = None if cfg.tie_embeddings else _tensor(tree["head"], device)
    return lm.LM(cfg, _tensor(tree["embed"], device), blocks,
                 _tree(tree["final_norm"], device), head)
