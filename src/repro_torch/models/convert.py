"""Carry an LM's parameters across between the JAX package and the port,
via numpy.

`params_from_numpy` takes the JAX package's param pytree
(`repro.models.api.build(cfg).init(key)`) with every leaf as a numpy array
and returns the port's `LM`. The stacked `superblocks` are unstacked along
their leading `n_repeats` axis into one block per layer, in the order the
forward pass runs them; every leaf keeps its layout (`(d_in, d_out)`
weights, so the port's `x @ w` has the JAX package's shapes) and its dtype
(norm scales and `lam` stay float32). bfloat16 crosses as a `uint16` view
of its bits (or as numpy's `bfloat16`), as in `weather/convert.py`.
`params_to_numpy` is the way back: the port's `LM` as the JAX package's
tree, the blocks stacked again into `superblocks`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.weather.convert import tensor_from_numpy, tensor_to_numpy


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


def _as_numpy(module) -> dict:
    """A `ParamTree` as nested dicts of numpy arrays."""
    out = {}
    for name in module._names:
        v = module[name]
        out[name] = (_as_numpy(v) if isinstance(v, torch.nn.Module)
                     else tensor_to_numpy(v))
    return out


def params_to_numpy(cfg: ModelConfig, params: lm.LM) -> dict:
    """The port's `LM` as the JAX package's param tree with numpy leaves
    (bf16 as `uint16` bits): the way back of `params_from_numpy`."""
    blocks = [_as_numpy(b.params) for b in params.blocks]
    period = len(cfg.pattern)

    def stack(trees):
        return {k: (stack([t[k] for t in trees]) if isinstance(v, dict)
                    else np.stack([t[k] for t in trees]))
                for k, v in trees[0].items()}

    tree = {"embed": tensor_to_numpy(params.embed),
            "superblocks": {f"b{i}": stack(blocks[i:cfg.n_repeats * period:
                                                  period])
                            for i in range(period)},
            "final_norm": _as_numpy(params.final_norm)}
    for r in range(cfg.n_remainder):
        tree[f"rem{r}"] = blocks[cfg.n_repeats * period + r]
    if not cfg.tie_embeddings:
        tree["head"] = tensor_to_numpy(params.head)
    return tree
