"""Reading `torch.profiler`'s device trace into what the metric readers use.

`profiled(fn)` runs `fn()` under the profiler, inside a host span
`bench.traced` that ends in a synchronise, and returns a `Trace`: every
device operation (kernels, copies, sets) with its start, end and name; the
host spans `bench.*` that the benchmark's own code opened
(`torch.profiler.record_function`); the traced window (the outer span);
the device's busy time (the union of its operations inside the window);
and the idle gaps between them, each labelled by the innermost benchmark
span that was open on the host at its middle. The raw events are read
(`kineto_results`), not `prof.events()`, whose tree of Python objects
takes tens of seconds at 10^5 kernels.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

OUTER = "bench.traced"
KERNELS_DIR = Path(__file__).resolve().parent / "kernels"


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[int, int, str]]            # device (start_ns, end_ns, name)
    spans: List[Tuple[int, int, str]]          # host bench.* spans
    window: Tuple[int, int]                    # the outer span, ns
    busy_s: float
    gaps: List[Tuple[float, str]]              # (seconds, host span), longest first
    attempted: int = 0                         # set by the traced workload
    steps: int = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def device_s(self, names=None) -> float:
        """Seconds of device operations, all or those whose kernel group
        (`kernel_group`) is in `names` (None in `names` takes the rest)."""
        total = 0
        for start, end, name in self.ops:
            if names is None or kernel_group(name) in names:
                total += end - start
        return total / 1e9

    def launches(self, group: str) -> List[float]:
        """Durations (s) of each device operation of a kernel group."""
        return [(e - s) / 1e9 for s, e, n in self.ops
                if kernel_group(n) == group]

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for start, end, name in self.ops:
            by[name] = by.get(name, 0) + end - start
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]


def port_kernels() -> Dict[str, "re.Pattern"]:
    """The program's own kernels, `{group: pattern}`, one file each under
    `kernels/`: a device operation belongs to the group whose function
    name (`match`, a whole identifier) it names, as in
    `void (anonymous namespace)::hdiff_stream<float, 1>(...)`."""
    out = {}
    for p in sorted(KERNELS_DIR.glob("*.json")):
        d = json.loads(p.read_text())
        out[d["kernel"]] = re.compile(r"(?:^|[\s*&:])" + re.escape(d["match"])
                                      + r"[<(]")
    return out


_PORT: Optional[Dict[str, "re.Pattern"]] = None


def kernel_group(name: str) -> Optional[str]:
    """The program's kernel a device operation belongs to, or None for an
    operation that is not one of the program's own kernels."""
    global _PORT
    if _PORT is None:
        _PORT = port_kernels()
    for group, pattern in _PORT.items():
        if pattern.search(name):
            return group
    return None


def profiled(fn) -> Trace:
    """Run `fn()` under `torch.profiler` and read its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(OUTER):
            fn()
            torch.cuda.synchronize()
    return read(prof)


def read(prof) -> Trace:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    no = lambda: False              # a method older releases lack
    ops, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", no)():
            continue
        name = e.name()
        if e.device_type() == cuda:
            if not getattr(e, "is_user_annotation", no)():
                ops.append((e.start_ns(), e.end_ns(), name))
        elif name == OUTER:
            window = (e.start_ns(), e.end_ns())
        elif name.startswith("bench."):
            spans.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        raise RuntimeError("the profiler recorded no benchmark window")
    lo, hi = window
    ops = sorted((max(s, lo), min(e, hi), n) for s, e, n in ops
                 if e > lo and s < hi)
    busy, gaps, at = 0, [], lo
    for start, end, _ in ops:
        if start > at:
            gaps.append((at, start))
        if end > at:
            busy += end - max(start, at)
            at = end
    if hi > at:
        gaps.append((at, hi))
    spans.sort()

    def label(t):
        inner = None
        for s, e, n in spans:
            if s > t:
                break
            if e >= t and (inner is None or s >= inner[0]):
                inner = (s, e, n)
        return inner[2] if inner else OUTER

    gaps = sorted((((e - s) / 1e9, label((s + e) // 2)) for s, e in gaps),
                  reverse=True)
    return Trace(ops=ops, spans=spans, window=window, busy_s=busy / 1e9,
                 gaps=gaps)
