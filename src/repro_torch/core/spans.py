"""Host spans of the program's layers, and the op lowering's copy counter.

`span(name)` is a profiler range while a profiler records and one shared
`contextlib.nullcontext()` otherwise, so a span costs one flag check when
nothing records; `spanned(name)` runs a whole function inside one. The
range is `torch.profiler.record_function`'s event without its trip through
the operator dispatcher (`torch._C._profiler._RecordFunctionFast`): at the
paper's domain on an H100's host, six spans a step added about 0.24 ms to
a traced step through `record_function` and 0.03 ms through the fast range
(PERF.md), the difference between a traced run that keeps pace with the
card and one that does not. It is recorded as an operator, so a kernel
launched straight inside it (a CUDA wrapper's library call) links to it.
The spans land in the profiler's own trace, on the clock of its device
operations, nested by time on the calling thread: a device operation
belongs to the innermost span its launch was made in. The program's spans
are named `nero.<layer>.<part>`:

* `nero.plan.run` — `ExecutionPlan.run`, the whole call;
* `nero.plan.round` — each round `run` runs, and `ExecutionPlan.step`;
* `nero.lower.stack`, `nero.lower.pad` — the single-device op lowering's
  re-stack and wrap pad (`weather/stencil_ops.py::_stack`, `_pad`, around
  `weather/dycore.py::stack_state` and `kernels/dycore_fused/ref.py::
  pad_periodic`, which stay plain for the references that share them);
* `nero.lower.staggered_w` — `kernels/dycore_fused/ops.py::staggered_w`;
* `nero.kernel.<name>` — a CUDA kernel wrapper (its checks, scratch and
  library call), `<name>` its key in `kernels/_build.py::LAUNCHES`.

Crops and unstacks are views: they launch nothing and stay in the round's
own time. Older ranges keep their names (`halo_exchange`, `moe_dispatch`,
`moe_combine`, `ssd_scan`) and the same gate.

`LOWERING` counts, since the last `reset_lowering()`, the rounds the plans
ran (`rounds`) and the timesteps they advanced (`steps`, k a round), and
the tensors the op lowering materialised (`copies`) with the bytes they
wrote (`bytes`): a stack that is not a view, each cat of a wrap pad, the
staggered velocity's roll and sum, a `contiguous` of `stencil_ops` that
copies. The mesh lowering's exchanges and wrap pads
(`weather/domain.py`) are not counted: `RIDES` counts what they move
between shards. It is the twin of `LAUNCHES` and `weather/domain.py::RIDES`.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict

import torch

__all__ = ["span", "spanned", "LOWERING", "reset_lowering", "copied",
           "contiguous"]

_recording = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()

LOWERING: Dict[str, int] = {"rounds": 0, "steps": 0, "copies": 0,
                             "bytes": 0}


def span(name: str):
    """A profiler range named `name` while a profiler records, else a
    shared no-op context."""
    return _range(name) if _recording() else _OFF


def spanned(name: str):
    """Decorator: the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _range(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def reset_lowering() -> None:
    for k in LOWERING:
        LOWERING[k] = 0


def copied(t: torch.Tensor) -> torch.Tensor:
    """Count `t`, a tensor the op lowering just wrote, in `LOWERING`;
    returns it."""
    LOWERING["copies"] += 1
    LOWERING["bytes"] += t.nbytes
    return t


def contiguous(t: torch.Tensor) -> torch.Tensor:
    """`t.contiguous()`, counted in `LOWERING` when it copies."""
    return t if t.is_contiguous() else copied(t.contiguous())
