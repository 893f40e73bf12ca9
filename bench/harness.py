"""One run of one cell: set-up, the measured window, the traced stretch,
the correctness check and the result line.

`run_cell` does everything but the look for a chip, which `run.py` makes,
so the tests drive it on the CPU with a planted fault. The order matters:
the device's peak memory is read before the program's state is freed and
before the reference runs, and the check runs after the window closes.
The comparison is the traffic kind's (`Workload.check`); the harness holds
the numbers it returns to the cell's `limits/<cell>.json`.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from bench import devtrace, manifest

BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is the JAX stack's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in BANNED)


@dataclasses.dataclass
class Run:
    """What a metric reader reads. What a cell's traffic kind defines (its
    sizes, its points a step, its step's bound) the reader takes from
    `workload`, the kind's `Workload`."""
    cell: manifest.Cell
    workload: Any
    setup_s: float
    setup_split: Dict[str, Any]
    window: Dict[str, float]         # window_s, attempted, and the kind's
                                     # counts (forecast_runs: forecasts,
                                     # steps, launches)
    peak_bytes: int
    trace: Optional[devtrace.Trace] = None
    dispatch_s: Optional[float] = None


def judge(numbers: Dict[str, float], answers, limits: Dict[str, float]):
    """`correct` and `failed` of a run: every number of the cell's limits
    file at or under its limit (a number the workload did not give reads
    inf), and the answers over any limit."""
    compared = {k: numbers.get(k, math.inf) for k in limits}
    correct = all(compared[k] <= limits[k] for k in limits)
    failed = sum(1 for _, g in answers
                 if not all(g.get(k, math.inf) <= limits[k] for k in limits))
    return compared, correct, failed


def _device_info(device: torch.device, peak: int) -> Dict[str, Any]:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": peak}


def run_cell(root, name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             split: Optional[Dict[str, Any]] = None,
             workload_hook=None) -> Dict[str, Any]:
    """One run of cell `name`. `t_start` is when the process began its
    set-up (imports), `split` the set-up's parts so far. `workload_hook`
    (tests only) may replace the workload's timed call. Returns the result
    line's object with `setup_split` beside it."""
    t_start = time.perf_counter() if t_start is None else t_start
    split = dict(split or {})
    dev = torch.device(device)
    cell = manifest.cell(root, name)
    kind = manifest.traffic_kind(cell)

    def lap(key, t0):
        split[key] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.load()
        split["built"] = bool(_build.build_log.get("built"))
        t = lap("library_s", t)
    wl = kind.Workload(cell, seed, device)
    if workload_hook is not None:
        workload_hook(wl)
    wl.draw_inputs()
    t = lap("inputs_s", t)
    wl.compile()
    t = lap("compile_s", t)
    wl.warm_up()
    t = lap("warmup_s", t)
    setup_s = time.perf_counter() - t_start
    split["pool"] = wl.pool_size

    window = wl.measure(seconds)
    tr = dispatch = None
    if traced:
        tr = wl.traced()
        dispatch = wl.dispatch_s()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    wl.release()
    result = wl.check()

    run = Run(cell=cell, workload=wl, setup_s=setup_s, setup_split=split,
              window=window, peak_bytes=peak, trace=tr, dispatch_s=dispatch)
    kind_key = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind_key]:
        value = manifest.reader(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cell.limits
    compared, correct, failed = judge(result["numbers"], result["answers"],
                                      limits)
    out = {"correct": correct, "attempted": window["attempted"]
           + (tr.attempted if tr is not None else 0),
           "failed": failed, "metrics": metrics,
           "device": _device_info(dev, peak)}
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {
            "device_ops": tr.top_ops(10),
            "idle_gaps": [[label, s] for s, label in tr.gaps[:10]]}
    out["check"] = {k: {"value": v, "limit": limits[k]}
                    for k, v in compared.items()}
    return {"result": out, "setup_split": split,
            "answers": result["answers"]}
