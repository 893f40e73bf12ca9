"""Per-rank operation counts of a step traced on fake tensors.

The twin of `repro.core.hlo_cost`. The JAX package costs a compiled SPMD
program by parsing its HLO; the port has no HLO, so it runs the step
itself on fake tensors (`torch._subclasses.FakeTensorMode`: shapes,
dtypes and devices, no storage) and counts every operation as it is
dispatched. `OpCounter` is that fake mode: everything made inside it is
fake, and within `counting()` each operation on the rank's own tensors is
costed by `hlo_cost`'s rules (`hlo_cost.py:14-25`):

  * a product (`mm`, `bmm`, `addmm`, `baddbmm`) 2 x out x contract, a
    convolution 2 x out x (its reduction); `addmm`'s add counts out more;
  * an elementwise op prod(out); a reduce prod(in); transcendentals
    (`exp`, `tanh`, `sigmoid`, `log`, `rsqrt`, ...) counted apart;
  * bytes accessed: the inputs and outputs of every operation that
    launches work, views and metadata at 0; a gather moves twice its
    output, a scatter or an in-place copy twice its update;
  * collectives: result bytes per device by kind (`all-reduce`,
    `all-gather`, `reduce-scatter`, `all-to-all`, and `scatter` and
    `broadcast`, which `roofline.wire_bytes` weighs 1), from the
    `_c10d_functional` ops DTensor's redistributes issue and the `c10d`
    ops of `parallel/policy.py`'s explicit collectives and of
    `distribute_tensor`; a group of one moves nothing;
  * a hand-written kernel on a fake tensor launches nothing: its wrapper
    returns an empty output and calls `record_kernel` with the kernel's
    own cost (`kernels/*/ops.py`), counted by name in `Cost.kernels`.

The count is per rank, on local tensors. DTensor dispatches an operation
on a DTensor as one on each rank's local shards; this mode sees both, and
counts only the second (an operation with a DTensor operand is the global
view of the same work, which `torch.utils.flop_counter.FlopCounterMode`
counts). DTensor also runs each operation once on global-shape fake
tensors to learn its output's metadata, re-entering this mode to do it:
nothing dispatched inside a nested entry is counted.

An eager trace visits every layer, every chunk of a chunked loop and every
recomputation of a checkpointed region, so there is no loop multiplier and
`hlo_cost`'s while-body parse has no twin. The port fuses nothing, so
there is no separate "bytes fused": `roofline.analyze` falls back to bytes
accessed, as the JAX package's does where that count is missing.

`OpCounter` also tracks the live bytes of fake storage (each storage
counted from its first output to its release), whose peak within
`counting()` is `peak_live_bytes`: the twin of the JAX dry-run's
XLA:CPU live bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._pytree import tree_flatten

__all__ = ["Cost", "OpCounter", "record_kernel", "is_fake", "active"]


@dataclasses.dataclass
class Cost:
    """`hlo_cost.Cost`'s fields, per device, and the kernels' calls and
    cost by name ({"calls", "flops", "bytes"})."""
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    ops: int = 0

    def kernel_calls(self) -> Dict[str, int]:
        return {k: int(v["calls"]) for k, v in self.kernels.items()}


_ACTIVE: Optional["OpCounter"] = None


def active() -> Optional["OpCounter"]:
    """The counter in its `counting()` window, or None."""
    return _ACTIVE


def is_fake(t) -> bool:
    """`t` is a fake or meta tensor: a wrapper given one launches nothing
    and records its kernel's cost (`record_kernel`)."""
    return isinstance(t, FakeTensor) or (isinstance(t, torch.Tensor)
                                         and t.is_meta)


def record_kernel(name: str, flops: float, bytes_accessed: float,
                  transcendentals: float = 0.0) -> None:
    """One call of kernel `name` with its own cost, to the active counter
    (nothing happens outside a `counting()` window)."""
    c = _ACTIVE
    if c is None:
        return
    cost = c.cost
    k = cost.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                       "bytes": 0.0})
    k["calls"] += 1
    k["flops"] += float(flops)
    k["bytes"] += float(bytes_accessed)
    cost.flops += float(flops)
    cost.transcendentals += float(transcendentals)
    cost.bytes_accessed += float(bytes_accessed)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

# no work launched: allocation without a write, metadata, scalars (views
# are `func.is_view`)
_FREE = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "device", "_unsafe_view",
    "set", "resize", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "record_stream",
))
_DOTS = frozenset(("mm", "bmm", "addmm", "baddbmm", "addbmm"))
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "sqrt", "rsqrt", "pow", "sin", "cos", "tan", "erf",
    "erfinv", "atan", "atan2", "softplus",
))
# transcendental with elementwise flops beside (silu = x * logistic(x);
# gelu's tanh form: 8 multiplies and adds around one tanh)
_TRANSCENDENTAL_PLUS = {"silu": 1, "gelu": 8}
_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum",
    "max_other", "min_other", "clamp", "clamp_min", "clamp_max", "where",
    "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_not", "bitwise_xor", "sign", "sgn", "floor", "ceil", "round",
    "trunc", "remainder", "fmod", "reciprocal", "square", "relu",
    "threshold_backward", "masked_fill", "addcmul", "addcdiv", "lerp",
    "isnan", "isinf", "isfinite", "copysign", "xlogy", "hardtanh",
    "sigmoid_backward", "tanh_backward", "silu_backward", "gelu_backward",
    "softplus_backward", "_foreach_add", "_foreach_mul",
))
_REDUCE = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
    "argmin", "any", "all", "norm", "linalg_vector_norm", "var", "std",
    "var_mean", "std_mean", "cumsum", "cumprod", "logsumexp",
))
# softmax: max-reduce, subtract, exp, sum-reduce, divide
_SOFTMAX = frozenset(("_softmax", "_log_softmax"))
_SOFTMAX_BWD = frozenset(("_softmax_backward_data",
                          "_log_softmax_backward_data"))
_GATHER = frozenset(("index", "index_select", "gather", "embedding",
                     "take_along_dim"))
# in-place updates: (the update's position among the arguments)
_SCATTER = {"index_put": 2, "scatter": 3, "scatter_add": 3,
            "scatter_reduce": 3, "index_add": 3, "index_copy": 3,
            "slice_scatter": 1, "select_scatter": 1, "copy": 1,
            "masked_scatter": 2, "index_fill": None}
# the collectives DTensor's redistributes (`_c10d_functional`),
# `parallel/policy.py` and `distribute_tensor` (`c10d`: a microbatched
# step scatters each microbatch's rows) issue; `_allgather_base` and
# `_reduce_scatter_base` are `dist.all_gather_into_tensor`'s and
# `dist.reduce_scatter_tensor`'s (the sequence-parallel seams)
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather": "all-gather",
    "_allgather_base": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter": "reduce-scatter",
    "all_to_all_single": "all-to-all", "scatter": "scatter",
    "broadcast": "broadcast",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _group_size(args) -> int:
    """The process group size a collective's arguments name (0: unknown)."""
    from torch.distributed import distributed_c10d as c10d

    for a in tree_flatten(args)[0]:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except Exception:       # noqa: BLE001 — not a group name
                continue
        if isinstance(a, torch.ScriptObject) and hasattr(a, "size"):
            try:
                return int(a.size())
            except Exception:       # noqa: BLE001 — not a process group
                continue
    return 0


def _cost_of(func, args, kwargs, out, cost: Cost) -> None:
    ns = func.namespace
    name = func._opname
    base = name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name
    if ns in ("_c10d_functional", "c10d"):
        kind = _COLLECTIVE_KIND.get(base)
        if kind is None:
            return
        outs = _tensors(out) or _tensors(args[:1])
        if kind == "all-gather" and ns == "c10d":
            outs = _tensors(args[0])            # the gathered list
        if _group_size(args) == 1:
            return
        res = sum(_nbytes(t) for t in outs)
        cost.collective_bytes[kind] = cost.collective_bytes.get(kind, 0) + res
        cost.bytes_accessed += res + sum(_nbytes(t) for t in _tensors(args))
        return
    if ns not in ("aten", "prims"):
        return
    if func.is_view or base in _FREE:
        return
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    cost.ops += 1
    o_el = sum(t.numel() for t in outs)
    if base in _GATHER:
        cost.bytes_accessed += 2 * sum(_nbytes(t) for t in outs)
        return
    if base in _SCATTER:
        pos = _SCATTER[base]
        upd = (args[pos] if pos is not None and len(args) > pos
               and isinstance(args[pos], torch.Tensor) else None)
        cost.bytes_accessed += 2 * (_nbytes(upd) if upd is not None
                                    else sum(_nbytes(t) for t in outs))
        return
    cost.bytes_accessed += (sum(_nbytes(t) for t in ins)
                            + sum(_nbytes(t) for t in outs))
    if base in _DOTS:
        a = args[1] if base in ("addmm", "baddbmm", "addbmm") else args[0]
        cost.flops += 2.0 * o_el * a.shape[-1]
        if base != "mm" and base != "bmm":
            cost.flops += o_el
    elif base == "convolution":
        w = args[1]
        cost.flops += 2.0 * o_el * (w.numel() // max(w.shape[0], 1))
    elif base in _TRANSCENDENTAL:
        cost.transcendentals += o_el
    elif base in _TRANSCENDENTAL_PLUS:
        cost.transcendentals += o_el
        cost.flops += _TRANSCENDENTAL_PLUS[base] * o_el
    elif base in _ELEMENTWISE:
        cost.flops += o_el
    elif base in _REDUCE:
        cost.flops += sum(t.numel() for t in ins)
        if base == "logsumexp":
            cost.transcendentals += ins[0].numel() + o_el
    elif base in _SOFTMAX:
        cost.flops += 2 * ins[0].numel() + 2 * o_el
        cost.transcendentals += o_el
    elif base in _SOFTMAX_BWD:
        cost.flops += ins[0].numel() + 2 * o_el


class OpCounter(FakeTensorMode):
    """A fake-tensor mode that counts the work dispatched in it (module
    docstring). Enter it to make fake tensors; wrap the step in
    `counting()` to cost it. `cost` and `peak_live_bytes` hold the last
    window's totals."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: Dict[int, int] = {}
        self._enters = 0
        self._depth = 0
        self._on = False

    def __enter__(self):
        self._enters += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._enters -= 1
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def counting(self):
        """Count what runs inside; `cost` and the live peak start anew."""
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("an OpCounter is already counting")
        self.cost = Cost()
        self.peak_live_bytes = self.live_bytes
        self._on = True
        _ACTIVE = self
        try:
            yield self
        finally:
            self._on = False
            _ACTIVE = None

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, out) -> None:
        for t in _tensors(out):
            if not isinstance(t, FakeTensor):
                continue
            s = t.untyped_storage()
            key = s._cdata
            if key in self._live:
                continue
            n = s.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(s, self._free, key)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        top = self._depth == 0 and self._enters == 1
        local = top and all(t.__class__ is FakeTensor or not isinstance(
            t, torch.Tensor) or t.is_meta for t in tree_flatten(
                (args, kwargs))[0])
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if local and out is not NotImplemented:
            self._track(out)
            if self._on:
                _cost_of(func, args, kwargs, out, self.cost)
        return out
