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

Sequence parallelism (`activation_rules(..., seq_shard=True)`, the JAX
package's `carry` pin with T over "model"; Megatron's sequence
parallelism). Inside an LM's T-sharded section (`seq_section`, entered by
`lm.apply` in train and prefill where the model axis is wider than 1 and
T > 1; nowhere else, so decode and the encoder-decoder do not change) a
rank carries its slice of T between blocks, T padded to a multiple of the
model size (`seq_span`); the norms and residual adds run on the slice.

* `seq_gather` all-gathers the slices to the whole (unpadded) T; its
  backward reduce-scatters, each rank having used the whole input for its
  own slice of the output. `seq_scatter` takes the rank's slice of a
  whole-T tensor; its backward all-gathers. `seq_slice` takes it without a
  collective (a partial gradient: zero outside the slice).
* `enter_tp` becomes `seq_gather` and `leave_tp` a reduce-scatter along T
  (Megatron's g and g-bar): a tensor-parallel layer computes on the whole
  T and leaves on the rank's slice. A layer that is not tensor-parallel
  runs whole on every model rank between `seq_gather` and `seq_slice`
  (`enter_layer`, `leave_layer`).
* A weight every model rank uses whole on its own rows (the norms, the
  embedding's lookup of the rank's slice, the head in the loss, and every
  layer that `is_tp` says is not tensor-parallel) takes "partial" use:
  its gradient sums over "model" (`_use`, so the layers and
  `gather_block_weights` cannot disagree).
* The MoE layer routes whole sequences in a `seq_whole` region: a
  tensor-parallel region inside it enters as the identity and leaves with
  an all-reduce both ways (its output's gradient is a rank's rows only),
  and the aux term, which every model rank computes whole, passes its
  gradient divided by the model size (`seq_partial`).
* `seq_sum` adds the ranks' partial sums over their slices (the loss).

The flash, xent and LRU kernels therefore see plain local tensors: flash
a rank's (batch shard, head shard), xent its rows against the head
gathered whole, the LRU its width shard; under `seq_shard` flash and the
LRU see the whole T as before and xent the rank's slice of the rows.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding as shd

_RULES: Optional[dict] = None


@contextlib.contextmanager
def activation_rules(batch_axes, mesh, model_axis: str = "model",
                     seq_shard: bool = False):
    """batch_axes: axis name / tuple for the batch dim (None: unsharded);
    `mesh`: the `DeviceMesh` the step runs on; `seq_shard`: sequence
    parallelism in an LM's train and prefill (module docstring)."""
    global _RULES
    old = _RULES
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    _RULES = {"batch": tuple(batch_axes or ()), "model": model_axis,
              "mesh": mesh, "seq_shard": bool(seq_shard)}
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


def seq_shard_on(t: int) -> bool:
    """Whether the rules shard an LM's T over "model": `seq_shard` set, a
    model axis wider than 1 and T > 1 (never decode)."""
    return bool(active() and _RULES["seq_shard"] and t > 1
                and model_size() > 1)


def seq_on() -> bool:
    """Inside a T-sharded section (`seq_section`), outside `seq_whole`."""
    return active() and isinstance(_RULES.get("seq"), int)


def _in_whole() -> bool:
    return active() and _RULES.get("seq") == "whole"


@contextlib.contextmanager
def seq_section(t: int):
    """An LM's T-sharded section over a sequence of `t` positions (where
    `seq_shard_on(t)`); a remat recompute captures it with the rules."""
    with using({**_RULES, "seq": t}):
        yield


@contextlib.contextmanager
def seq_whole():
    """A whole-T region of a T-sharded section (the MoE layer's)."""
    with using({**_RULES, "seq": "whole"}):
        yield


def seq_span(t: int):
    """(first position, positions) of this model rank's slice of T
    (T padded to a multiple of the model size)."""
    tl = -(-t // model_size())
    return model_rank() * tl, tl


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
    # a weight used whole: on every model rank alike, or in a T-sharded
    # section on the rank's own rows (the gradient sums over "model")
    whole = "partial" if seq_on() else "full"
    if parent == "ffn" and leaf == "router":
        return whole
    if not is_tp(cfg, "moe" if parent == "ffn" and ndim == 3 else parent):
        return whole
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


def _pad_t(x, n: int):
    """x padded with zeros along T (dim 1) to n positions."""
    if x.shape[1] == n:
        return x
    pad = x.new_zeros((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def _seq_info():
    """(group, model size, model rank, T, slice) of the section."""
    t = _RULES["seq"]
    m = model_size()
    return _groups([_RULES["model"]])[0], m, model_rank(), t, -(-t // m)


# `dist.all_gather_into_tensor` and `dist.reduce_scatter_tensor` where
# their newer names are missing
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _seq_apply(kind: str, x, info):
    """One step along T: "slice" (the whole T to the rank's slice, no
    collective), "gather" (the slices all-gathered, cropped to T) or
    "reduce_scatter" (the whole T's partial sums, padded, summed over the
    ranks into each one's slice)."""
    group, m, r, t, tl = info
    if kind == "slice":
        return _pad_t(x, m * tl).narrow(1, r * tl, tl)
    if kind == "gather":
        xs = x.movedim(1, 0).contiguous()
        out = xs.new_empty((m * tl,) + tuple(xs.shape[1:]))
        _all_gather(out, xs, group=group)
        return out.narrow(0, 0, t).movedim(0, 1).contiguous()
    xs = _pad_t(x, m * tl).movedim(1, 0).contiguous()
    out = xs.new_empty((tl,) + tuple(xs.shape[1:]))
    _reduce_scatter(out, xs, group=group)
    return out.movedim(0, 1).contiguous()


class _Seq(torch.autograd.Function):
    """A step along T forward and another one backward (`_seq_apply`)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.info, ctx.bwd = _seq_info(), bwd
        return _seq_apply(fwd, x, ctx.info)

    @staticmethod
    def backward(ctx, g):
        return _seq_apply(ctx.bwd, g, ctx.info), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _tp_on() -> bool:
    return model_size() > 1


def enter_tp(x):
    """Start of a tensor-parallel region over "model" (identity forward;
    the backward all-reduces the gradient). In a T-sharded section the
    slices all-gathered (`seq_gather`); in a `seq_whole` region the
    identity both ways."""
    if _in_whole():
        return x
    if seq_on():
        return seq_gather(x)
    return _Enter.apply(x) if _tp_on() else x


def leave_tp(x):
    """End of a tensor-parallel region: the sum of the ranks' partial
    products. In a T-sharded section each rank's slice of it (a
    reduce-scatter along T; the backward all-gathers); in a `seq_whole`
    region the gradient, a rank's rows only, is all-reduced too."""
    if _in_whole():
        return _Enter.apply(_Leave.apply(x))
    if seq_on():
        return _Seq.apply(x, "reduce_scatter", "gather")
    return _Leave.apply(x) if _tp_on() else x


def seq_gather(x):
    """A rank's slice of T -> the whole T (an all-gather; the backward
    reduce-scatters). The identity outside a T-sharded section."""
    return _Seq.apply(x, "gather", "reduce_scatter") if seq_on() else x


def seq_scatter(x):
    """The whole T -> this rank's slice (the backward all-gathers)."""
    return _Seq.apply(x, "slice", "gather") if seq_on() else x


def seq_slice(x):
    """The whole T -> this rank's slice, without a collective: the
    gradient is zero outside the slice (a partial sum over "model")."""
    return _seq_apply("slice", x, _seq_info()) if seq_on() else x


def enter_layer(x, tp: bool):
    """A layer's input: `enter_tp` where it is tensor-parallel, else the
    whole T (`seq_gather`) in a T-sharded section."""
    return enter_tp(x) if tp else seq_gather(x)


def leave_layer(x, tp: bool):
    """A layer's output: `leave_tp` where it is tensor-parallel, else the
    rank's slice (`seq_slice`) in a T-sharded section."""
    return leave_tp(x) if tp else seq_slice(x)


def seq_partial(x):
    """A term every model rank computes whole in a T-sharded section (the
    MoE aux term), whose parameters' gradients sum over "model": identity
    forward, the gradient divided by the model size."""
    return _ScaleGrad.apply(x, 1.0 / model_size()) if seq_on() else x


def seq_sum(x):
    """The ranks' partial sums over their slices of T -> the sum over the
    whole T (an all-reduce over "model"; identity backward)."""
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
