"""Logical-axis sharding rules for the port's parameters, batches and
caches, and their placements on a `torch.distributed` device mesh.

A port of `repro.parallel.sharding`. One table maps a parameter's path to
a spec per run kind:

  * train: FSDP over "data" on the embed/contraction dim + TP/EP over
    "model" on heads/ffn/experts/vocab; batch over ("pod", "data").
  * serve (prefill/decode): weights TP over "model" only; KV caches
    batch -> "data", seq -> "model" (batch 1: seq -> ("data", "model")).

A spec (`P`) is a tuple with one entry a tensor dim: None (not sharded),
a mesh axis name, or a tuple of names (sharded over their product, the
first outermost). The rules key on the JAX package's paths: a port
parameter name (`blocks.3.params.attn.wq`) is mapped onto the path
`models/convert.py::params_to_numpy` gives that leaf (`superblocks/b0/
attn/wq`, or `rem0/attn/wq` past the scanned periods; an encoder-decoder's
`enc_blocks/...`, `dec_blocks/...`), so both packages read the same
(parent, leaf) names. The port's blocks are unstacked, one module a layer,
so the leading None the JAX package gives a stacked leaf (its scan axis)
is dropped: a port spec is the JAX spec of that leaf without it. Caches
likewise (`cache_sharding`).

A rule function takes any mesh with axis names and sizes: the port's
`launch/mesh.py::Mesh` (`axis_names`, a name -> size `shape`) or a
`torch.distributed` `DeviceMesh` (`mesh_dim_names`). `placements` turns a
spec into DTensor placements on a `DeviceMesh` (an axis named at tensor
dim i is `Shard(i)` on that mesh dim, every other mesh dim `Replicate()`),
and `distribute` gives a module DTensor parameters by the table.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

STACK_KEYS = ("superblocks", "enc_blocks", "dec_blocks")


class P(tuple):
    """A partition spec: one entry a tensor dim (None, an axis name, or a
    tuple of axis names; a tuple of one name is that name, as in
    `jax.sharding.PartitionSpec`)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of either kind of mesh, in axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def param_spec(names: Tuple[str, ...], ndim: int, kind: str,
               expert_div: bool = True) -> P:
    """The full rule table (the JAX package's, entry for entry) on a JAX
    path. kind: 'train' (FSDP+TP) or 'serve' (TP only). `ndim` counts a
    stacked leaf's scan axis, which gets a leading None.

    expert_div: n_experts divides the model axis -> expert-parallel MoE
    weights; otherwise tensor-parallel over d_ff."""
    fsdp = "data" if kind == "train" else None
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    stacked = any(s in names for s in STACK_KEYS)
    base_ndim = ndim - 1 if stacked else ndim

    def done(spec) -> P:
        assert len(spec) <= base_ndim, (names, ndim, spec)
        spec = tuple(spec) + (None,) * (base_ndim - len(spec))
        return P(*(((None,) if stacked else ()) + spec))

    m = "model"
    d = fsdp

    if leaf == "embed":
        return done((m, d))
    if leaf == "head":
        return done((d, m))
    if parent in ("attn", "xattn"):
        if leaf in ("wq", "wk", "wv"):
            return done((d, m))
        if leaf == "wo":
            return done((m, d))
        return done(())                         # qk-norm scales
    if parent == "ffn":
        if leaf == "router":
            return done(())
        if base_ndim == 3:                      # MoE experts (E, d, f)
            if leaf in ("wi", "wg"):
                return done((m, d, None) if expert_div else (None, d, m))
            if leaf == "wo":
                return done((m, None, d) if expert_div else (None, m, d))
        if leaf in ("wi", "wg"):
            return done((d, m))
        if leaf == "wo":
            return done((m, d))
    if parent == "rec":
        if leaf in ("w_branch_x", "w_branch_g"):
            return done((d, m))
        if leaf == "conv":
            return done((None, m))
        if leaf in ("w_rec_gate", "w_in_gate"):
            return done((None, m))
        if leaf == "lam":
            return done((m,))
        if leaf == "w_out":
            return done((m, d))
    if parent == "ssd":
        if leaf == "in_proj":
            return done((d, m))
        if leaf == "conv":
            return done((None, m))
        if leaf == "norm_scale":
            return done((m,))
        if leaf == "out_proj":
            return done((m, d))
        return done(())                         # A_log, D, dt_bias
    return done(())                             # norms & everything scalar


def jax_path(cfg, name: str) -> Tuple[Tuple[str, ...], bool]:
    """A port parameter name as the JAX package's path to that leaf, and
    whether the JAX leaf is stacked (has a leading scan axis)."""
    parts = name.split(".")
    if parts[0] in ("enc_blocks", "dec_blocks"):       # `<kind>.<i>.params.`
        return (parts[0],) + tuple(parts[3:]), True
    if parts[0] == "blocks":
        i, period = int(parts[1]), len(cfg.pattern)
        rest = tuple(parts[3:])
        if i < cfg.n_repeats * period:
            return ("superblocks", f"b{i % period}") + rest, True
        return (f"rem{i - cfg.n_repeats * period}",) + rest, False
    return tuple(parts), False


def params_sharding(params: nn.Module, mesh, kind: str) -> Dict[str, P]:
    """{parameter name: spec} for a model's parameters (its `LM` or
    `EncDec`, of any device: `Model.param_shapes()` will do), by the rule
    table. A MoE leaf is expert-parallel where its experts divide the
    model axis (`expert_div`), as in the JAX package."""
    model_par = mesh_shape(mesh).get("model", 1)
    out = {}
    for name, p in params.named_parameters():
        shape = tuple(p.shape)
        names, stacked = jax_path(params.cfg, name)
        expert_div = True
        if len(shape) >= 3 and "ffn" in names:
            expert_div = shape[0] % model_par == 0
        spec = param_spec(names, len(shape) + stacked, kind,
                          expert_div=expert_div)
        out[name] = P(*spec[1:]) if stacked else spec
    return out


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------

def batch_sharding(mesh, batch_size: int):
    """Batch dim spec: over ("pod", "data") when they divide the batch."""
    shape = mesh_shape(mesh)
    n = 1
    chosen = []
    for a in ("pod", "data"):
        if a in shape and batch_size % (n * shape[a]) == 0:
            chosen.append(a)
            n *= shape[a]
    return tuple(chosen) if chosen else None


def data_spec(mesh, batch_size: int, ndim: int) -> P:
    b = batch_sharding(mesh, batch_size)
    return P(*((b,) + (None,) * (ndim - 1)))


def cache_spec(names: Tuple[str, ...], ndim: int, mesh,
               batch_size: int) -> P:
    """KV / state cache rules on a JAX path (the JAX package's). A stacked
    leading scan dim -> None.

    attn k/v (R, B, S, K, hd): B->data axes, S->"model"
      (batch==1 long-context: S->("data","model")).
    rec/ssd states: B->data, width/heads dim -> "model".
    """
    leaf = names[-1]
    b_axes = batch_sharding(mesh, batch_size)
    axes = axis_names(mesh)
    stacked = (any(s in names for s in STACK_KEYS)
               or (leaf in ("k", "v") and ndim == 5)
               or (leaf in ("k_scale", "v_scale") and ndim == 4)
               or bool(names and names[0] == "dec"))
    base = ndim - 1 if stacked else ndim

    if leaf in ("k", "v", "k_scale", "v_scale") and base in (3, 4):
        seq_ax = ("model" if b_axes
                  else tuple(a for a in ("data", "model") if a in axes))
        spec = ((b_axes, seq_ax, None, None) if base == 4
                else (b_axes, seq_ax, None))    # int8 KV scales (B, S, K)
    elif leaf == "h" and base == 2:           # rglru state (B, W)
        spec = (b_axes, "model")
    elif leaf == "h" and base == 4:           # ssd state (B, nh, p, n)
        spec = (b_axes, "model", None, None)
    elif leaf == "conv" and base == 3:        # conv state (B, cw-1, W)
        spec = (b_axes, None, "model")
    elif leaf == "enc" and base == 3:         # whisper encoder states
        spec = (b_axes, None, None)
    else:
        spec = tuple([b_axes] + [None] * (base - 1)) if base else ()
    spec = tuple(spec) + (None,) * (base - len(spec))
    return P(*(((None,) if stacked else ()) + spec))


def _cache_path(cfg, layer: int) -> Tuple[Tuple[str, ...], bool]:
    """A decoder-only cache layer's JAX path prefix and whether the JAX
    leaf is stacked."""
    period = len(cfg.pattern)
    if layer < cfg.n_repeats * period:
        return ("superblocks", f"b{layer % period}"), True
    return (f"rem{layer - cfg.n_repeats * period}",), False


def cache_sharding(cache, mesh, batch_size: int, cfg):
    """The port's cache (`Model.init_cache`: a list of per-layer dicts, or
    an encoder-decoder's {"dec": [...], "enc": states}) as the same tree
    of specs, each the JAX package's spec for that leaf without a stacked
    leaf's leading None."""

    def one(names, stacked, leaf):
        spec = cache_spec(names, leaf.dim() + stacked, mesh, batch_size)
        return P(*spec[1:]) if stacked else spec

    def layer(prefix, stacked, tree):
        return {k: one(prefix + (k,), stacked, v) for k, v in tree.items()}

    if isinstance(cache, Mapping):                      # encoder-decoder
        out = {"dec": [layer(("dec", "self"), True, c)
                       for c in cache["dec"]]}
        if "enc" in cache:
            out["enc"] = one(("enc",), False, cache["enc"])
        return out
    return [layer(*_cache_path(cfg, i), c) for i, c in enumerate(cache)]


# ---------------------------------------------------------------------------
# placements on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec: P, mesh) -> list:
    """DTensor placements of `spec` on `mesh`: `Shard(i)` on each mesh dim
    that spec entry i names, `Replicate()` on every other."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for a in axis_names(mesh):
        dims = [i for i, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def is_distributed(t) -> bool:
    """`t` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def is_rank0() -> bool:
    """This process is rank 0 of the default process group, or there is
    no group (it alone writes checkpoints and logs)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def batch_rank(mesh, axes) -> Tuple[int, int]:
    """This rank's shard of a batch split over `axes` of a `DeviceMesh`
    (the first outermost; an axis the mesh lacks counts once) and the
    number of shards."""
    names = tuple(mesh.mesh_dim_names)
    r, n = 0, 1
    for a in axes or ():
        if a in names:
            k = int(mesh.size(names.index(a)))
            r = r * k + (int(mesh.get_local_rank(a)) if k > 1 else 0)
            n *= k
    return r, n


def _set_param(root: nn.Module, name: str, value: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    mod = root
    for p in path:
        mod = getattr(mod, p)
    mod._parameters[leaf] = nn.Parameter(value, requires_grad=False)


def distribute(params: nn.Module, mesh, kind: str = "train",
               specs: Optional[Dict[str, P]] = None) -> nn.Module:
    """`params` with every parameter a DTensor on `mesh` placed by the rule
    table (`specs`, default `params_sharding(params, mesh, kind)`), in
    place; returned. A full tensor goes to the mesh's device and each rank
    keeps its shard; a module already distributed is returned as it is."""
    from torch.distributed.tensor import distribute_tensor

    named = list(params.named_parameters())
    if all(is_distributed(p) for _, p in named):
        return params
    specs = specs or params_sharding(params, mesh, kind)
    for name, p in named:
        if not is_distributed(p):
            _set_param(params, name, distribute_tensor(
                p.detach(), mesh, placements(specs[name], mesh)))
    return params
