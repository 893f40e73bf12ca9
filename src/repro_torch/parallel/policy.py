"""Activation rules and weight gathers for the LM on a device mesh.

The twin of `repro.parallel.policy`. The JAX package pins activations at a
few block seams with `with_sharding_constraint` and lets GSPMD partition
the rest. The port runs every layer on each rank's local tensors instead:
the batch rows of its data shard, whole over "model", and its own shard
of each weight. So it has no activation seam to pin: a batch DTensor
becomes this rank's rows once (`batch_local`), and what the layers carry
from there on is local. Rules are process-global, set around a step
(`activation_rules`); when unset (unit tests, one device, serving) every
function here is the identity on what it is given, so no single-device
path changes.

* `is_tp(cfg, layer)` says whether a layer runs tensor-parallel over
  "model" under the rules; the layers and `gather_block_weights` both
  read it, so they cannot disagree.
* `gather_block_weights(params, cfg)` makes a block's DTensor
  weights local at their use (the JAX package's `fsdp_gather` pin, always
  on here): each is all-gathered over the data axes (FSDP) and keeps its
  "model" shard where its layer is tensor-parallel, or is gathered whole
  where it is not (`_use`). The gather's backward reduce-scatters the
  gradient into the parameter's own placements: a `Partial` sum over the
  batch axes, and over "model" the shard (tensor-parallel use), a
  `Replicate` (every model rank computed the same) or a `Partial` sum (a
  rank used its own slice of a whole weight).
* A tensor-parallel region starts with `enter_tp` (identity; its backward
  all-reduces the input's gradient over "model") and ends with
  `leave_tp` (all-reduce of the partial product; identity backward), as
  Megatron's f and g operators. `gather_model` all-gathers a
  model-sharded activation (the RG-LRU's gates read the whole width).
* `batch_mean` turns a rank's mean over its rows into the mean over the
  global batch (a sum over the batch axes); `gather_batch` all-gathers
  rows (the MoE router's chunks where a data shard would split one).

The flash, xent and LRU kernels therefore see plain local tensors: flash
a rank's (batch shard, head shard), xent its rows against the head
gathered whole, the LRU its width shard.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding as shd

_RULES: Optional[dict] = None


@contextlib.contextmanager
def activation_rules(batch_axes, mesh, model_axis: str = "model"):
    """batch_axes: axis name / tuple for the batch dim (None: unsharded);
    `mesh`: the `DeviceMesh` the step runs on."""
    global _RULES
    old = _RULES
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    _RULES = {"batch": tuple(batch_axes or ()), "model": model_axis,
              "mesh": mesh}
    try:
        yield
    finally:
        _RULES = old


def active() -> bool:
    return _RULES is not None


def current() -> Optional[dict]:
    """The rules in force (None: unset), to re-enter with `using`."""
    return _RULES


@contextlib.contextmanager
def using(rules: Optional[dict]):
    """Re-enter captured rules, e.g. where a checkpointed region is
    recomputed in a backward that runs outside the forward's rules."""
    global _RULES
    old = _RULES
    _RULES = rules
    try:
        yield
    finally:
        _RULES = old


def rules_for(params, batch):
    """The rules a loss on distributed `params` needs, derived from their
    mesh and the global batch, where none are set; else a no-op."""
    if _RULES is not None:
        return contextlib.nullcontext()
    p = next(iter(params.parameters()))
    if not shd.is_distributed(p):
        return contextlib.nullcontext()
    mesh = p.device_mesh
    return activation_rules(shd.batch_sharding(mesh, batch["tokens"].shape[0]),
                            mesh)


# ---------------------------------------------------------------------------
# mesh facts under the rules
# ---------------------------------------------------------------------------

def _names():
    return tuple(_RULES["mesh"].mesh_dim_names)


def _size(axis) -> int:
    if not active() or axis not in _names():
        return 1
    return int(_RULES["mesh"].size(_names().index(axis)))


def model_size() -> int:
    return _size(_RULES["model"]) if active() else 1


def model_rank() -> int:
    if model_size() == 1:
        return 0
    return int(_RULES["mesh"].get_local_rank(_RULES["model"]))


def batch_shards() -> int:
    if not active():
        return 1
    n = 1
    for a in _RULES["batch"]:
        n *= _size(a)
    return n


def _groups(axes):
    mesh = _RULES["mesh"]
    return [mesh.get_group(a) for a in axes if _size(a) > 1]


def _all_reduce(x, groups):
    x = x.contiguous().clone()
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


def batch_local(x):
    """A batch DTensor as this rank's rows (its shard over the batch axes,
    whole over every other axis); anything else as it is."""
    if not (active() and shd.is_distributed(x)):
        return x
    spec = (_RULES["batch"] or None,) + (None,) * (x.dim() - 1)
    return x.redistribute(x.device_mesh,
                          shd.placements(spec, x.device_mesh)).to_local()


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def gather(p, use: str = "full"):
    """A DTensor weight as a local tensor for this rank's computation;
    anything else as it is. use: "tp" keeps its "model" placement (the
    layer computes tensor-parallel on the shard), "full" gathers it whole
    (every model rank computes the same with it), "partial" gathers it
    whole for a rank-dependent use (the gradient sums over "model")."""
    if not shd.is_distributed(p):
        return p
    from torch.distributed.tensor import Partial, Replicate

    mesh = p.device_mesh
    batch = _RULES["batch"] if _RULES is not None else ()
    model = _RULES["model"] if _RULES is not None else "model"
    target, grads = [], []
    for name, pl in zip(mesh.mesh_dim_names, p.placements):
        keep = name == model and use == "tp"
        target.append(pl if keep else Replicate())
        if name in batch:
            grads.append(Partial())
        elif name == model:
            grads.append(pl if keep else
                         Partial() if use == "partial" else Replicate())
        else:
            grads.append(Replicate())
    return p.redistribute(mesh, target).to_local(grad_placements=grads)


def _attn_tp(cfg, m: int) -> bool:
    """Whether attention runs tensor-parallel over m model ranks: the query
    heads divide, and each rank's heads read whole kv heads."""
    h, kh = cfg.n_heads, cfg.n_kv_heads
    if h % m:
        return False
    hl, g = h // m, h // kh
    return kh % m == 0 or (hl % g == 0 if hl >= g else g % hl == 0)


def _kv_heads(cfg, m: int, r: int):
    """The kv heads [lo, hi) that model rank r's query heads read."""
    hl, g = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
    return (r * hl) // g, ((r + 1) * hl - 1) // g + 1


def is_tp(cfg, layer: str) -> bool:
    """Whether `layer` ("attn", "xattn", "ffn", "moe" or "rec") runs
    tensor-parallel over "model" under the rules: its weights keep their
    "model" shard at use, its input enters with `enter_tp` and its partial
    output leaves with `leave_tp`. False without rules, on one model rank,
    and where the shard would not divide the layer's heads or width (the
    weights are then gathered whole and every model rank computes the
    same)."""
    m = model_size()
    if m == 1:
        return False
    if layer in ("attn", "xattn"):
        return _attn_tp(cfg, m)
    if layer == "moe":                       # experts, or their d_ff
        return cfg.moe.n_experts % m == 0 or cfg.d_ff % m == 0
    if layer == "ffn":
        return cfg.d_ff % m == 0
    if layer == "rec":
        return (cfg.rec.rnn_width or cfg.d_model) % m == 0
    return False                             # ssd, norms


def _use(cfg, parent: str, leaf: str, ndim: int) -> str:
    if parent == "ffn" and leaf == "router":
        return "full"
    if not is_tp(cfg, "moe" if parent == "ffn" and ndim == 3 else parent):
        return "full"
    if parent in ("attn", "xattn"):
        if leaf not in ("wq", "wk", "wv", "wo"):
            return "partial"            # qk-norm scales, on a rank's heads
        if leaf in ("wk", "wv") and cfg.n_kv_heads % model_size():
            return "kv_slice"
    return "tp"


def gather_block_weights(params, cfg=None):
    """A block's weights (a `ParamTree`) made local at their use under the
    rules (module docstring): a nested dict of local tensors named as the
    tree. Without DTensor weights the tree itself is returned."""
    if not shd.is_distributed(next(iter(params.parameters()), None)):
        return params
    r = model_rank()

    def walk(tree, parent):
        out = {}
        for name in tree._names:
            v = tree[name]
            if isinstance(v, torch.nn.Module):
                out[name] = walk(v, name)
                continue
            use = _use(cfg, parent, name, v.dim())
            if use == "kv_slice":
                lo, hi = _kv_heads(cfg, model_size(), r)
                out[name] = gather(v, "partial")[:, lo * cfg.hd:hi * cfg.hd]
            else:
                out[name] = gather(v, use)
        return out

    return walk(params, "")


# ---------------------------------------------------------------------------
# tensor-parallel and batch collectives (autograd-aware)
# ---------------------------------------------------------------------------

class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.groups = _groups([_RULES["model"]])
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups)


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x, _groups([_RULES["model"]]))

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        m, r = model_size(), model_rank()
        ctx.dim, ctx.n, ctx.r = dim, x.shape[dim], r
        ctx.groups = _groups([_RULES["model"]])
        parts = [torch.empty_like(x) for _ in range(m)]
        dist.all_gather(parts, x.contiguous(), group=ctx.groups[0])
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.groups)
        return g.narrow(ctx.dim, ctx.r * ctx.n, ctx.n).contiguous(), None


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.n = batch_shards()
        return _all_reduce(x, _groups(_RULES["batch"])) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n


def _batch_rank() -> int:
    return shd.batch_rank(_RULES["mesh"], _RULES["batch"])[0]


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        n = batch_shards()
        ctx.rows, ctx.r = x.shape[0], _batch_rank()
        ctx.groups = _groups(_RULES["batch"])
        out = x.contiguous()
        # gather the innermost batch axis first, so rows end rank-major
        for a in reversed(_RULES["batch"]):
            if _size(a) == 1:
                continue
            parts = [torch.empty_like(out) for _ in range(_size(a))]
            dist.all_gather(parts, out, group=_RULES["mesh"].get_group(a))
            out = torch.cat(parts, dim=0)
        assert out.shape[0] == n * ctx.rows
        return out

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.groups)
        return g.narrow(0, ctx.r * ctx.rows, ctx.rows).contiguous()


def _tp_on() -> bool:
    return model_size() > 1


def enter_tp(x):
    """Start of a tensor-parallel region over "model" (identity forward;
    the backward all-reduces the gradient)."""
    return _Enter.apply(x) if _tp_on() else x


def leave_tp(x):
    """End of a tensor-parallel region: the sum of the ranks' partial
    products."""
    return _Leave.apply(x) if _tp_on() else x


def gather_model(x, dim: int = -1):
    """A model-sharded activation gathered whole along `dim`."""
    if not _tp_on():
        return x
    return _GatherModel.apply(x, dim % x.dim())


def batch_mean(x):
    """A rank's mean over its rows -> the mean over the global batch."""
    if batch_shards() == 1:
        return x
    return _BatchMean.apply(x)


def gather_batch(x):
    """This rank's rows -> the global batch's, in global order."""
    if batch_shards() == 1:
        return x
    return _GatherBatch.apply(x)


def local_rows(x_global, rows: int):
    """This rank's `rows` of a global-batch tensor."""
    if batch_shards() == 1:
        return x_global
    return x_global.narrow(0, _batch_rank() * rows, rows)
