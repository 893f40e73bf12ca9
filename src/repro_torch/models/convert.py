"""Carry a model's parameters across between the JAX package and the
port, via numpy.

`params_from_numpy` takes the JAX package's param pytree
(`repro.models.api.build(cfg).init(key)`) with every leaf as a numpy array
and returns the port's `LM`, or its `EncDec` for an encoder-decoder
config. The stacked `superblocks` are unstacked along their leading
`n_repeats` axis into one block per layer, in the order the forward pass
runs them (an encoder-decoder's `enc_blocks` and `dec_blocks` along their
layer axis); every leaf keeps its layout (`(d_in, d_out)` weights, so the
port's `x @ w` has the JAX package's shapes; a MoE layer's `wi`/`wg`/`wo`
stacked over experts) and its dtype (norm scales, `lam`, the MoE router
and the SSD's `A_log`, `D`, `dt_bias` and `norm_scale` stay float32).
bfloat16 crosses as a `uint16` view of its bits (or as numpy's
`bfloat16`), as in `weather/convert.py`. `params_to_numpy` is the way
back: the port's parameters as the JAX package's tree, the blocks stacked
again.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
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


def params_from_numpy(cfg: ModelConfig, tree: Mapping, device):
    """The JAX package's params (numpy leaves) as the port's `LM` (or
    `EncDec`) on `device`."""
    if cfg.encdec:
        return encdec.EncDec(
            cfg, _tensor(tree["embed"], device),
            [_tree(tree["enc_blocks"], device, i)
             for i in range(cfg.encdec.encoder_layers)],
            _tree(tree["enc_norm"], device),
            [_tree(tree["dec_blocks"], device, i)
             for i in range(cfg.n_layers)],
            _tree(tree["final_norm"], device), _tensor(tree["head"], device))
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


def _stack(trees):
    """Dicts of equal structure -> one dict, each leaf stacked on a new
    leading axis."""
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else np.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def params_to_numpy(cfg: ModelConfig, params) -> dict:
    """The port's `LM` (or `EncDec`) as the JAX package's param tree with
    numpy leaves (bf16 as `uint16` bits): the way back of
    `params_from_numpy`."""
    if cfg.encdec:
        return {"embed": tensor_to_numpy(params.embed),
                "enc_blocks": _stack([_as_numpy(b.params)
                                      for b in params.enc_blocks]),
                "enc_norm": _as_numpy(params.enc_norm),
                "dec_blocks": _stack([_as_numpy(b.params)
                                      for b in params.dec_blocks]),
                "final_norm": _as_numpy(params.final_norm),
                "head": tensor_to_numpy(params.head)}
    blocks = [_as_numpy(b.params) for b in params.blocks]
    period = len(cfg.pattern)
    tree = {"embed": tensor_to_numpy(params.embed),
            "superblocks": {f"b{i}": _stack(blocks[i:cfg.n_repeats * period:
                                                   period])
                            for i in range(period)},
            "final_norm": _as_numpy(params.final_norm)}
    for r in range(cfg.n_remainder):
        tree[f"rem{r}"] = blocks[cfg.n_repeats * period + r]
    if not cfg.tie_embeddings:
        tree["head"] = tensor_to_numpy(params.head)
    return tree
