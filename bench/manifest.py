"""Finding a cell's parts by name.

`BENCHMARK.json` at the root of the checkout lists the configurations, the
cells and the metrics. Everything else is found by name under `bench/`:

* a configuration: the file its entry names (`configs/<config>.json`);
* a traffic mix: `traffic/<traffic>.json`, whose `kind` names the module
  that generates it, `traffic/<kind>.py`;
* an op a mix names: `ops/<op>.py`;
* a cell's limits of the correctness check: `limits/<cell>.json`;
* a metric: its reader, `metrics/<metric>.py`, a function
  `read(run) -> float | None`.

So a later change adds a configuration, a mix, a cell or a metric by
adding files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List

BENCH = "bench"
_UNSAFE = re.compile(r"[^A-Za-z0-9_.-]")


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    metrics: Dict[str, List[Dict[str, Any]]]   # "end_to_end"/"per_layer"
    root: Path


def load(root) -> Dict[str, Any]:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _safe(name: str) -> str:
    if not name or _UNSAFE.search(name) or name.startswith("."):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def cell(root, name: str) -> Cell:
    root = Path(root)
    bench = load(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{[w['name'] for w in bench['workloads']]})")
    entry = entries[0]
    conf = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / BENCH / "traffic"
                          / f"{_safe(entry['traffic'])}.json").read_text())
    limits = json.loads((root / BENCH / "limits"
                         / f"{_safe(name)}.json").read_text())
    metrics = {kind: [m for m in bench[kind]
                      if "workloads" not in m or name in m["workloads"]]
               for kind in ("end_to_end", "per_layer")}
    return Cell(name=name, config=config, traffic=traffic,
                limits={k: float(v["limit"]) for k, v in limits.items()},
                metrics=metrics, root=root)


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_kind(cell: Cell):
    kind = _safe(cell.traffic["kind"])
    return _module(cell.root / BENCH / "traffic" / f"{kind}.py",
                   f"bench_traffic_{kind}")


def op(root, name: str):
    return _module(Path(root) / BENCH / "ops" / f"{_safe(name)}.py",
                   f"bench_op_{name}")


def reader(root, metric: str):
    return _module(Path(root) / BENCH / "metrics" / f"{_safe(metric)}.py",
                   "bench_metric_" + metric.replace(".", "_"))
