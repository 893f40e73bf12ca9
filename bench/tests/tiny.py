"""A copy of the benchmark with small cells that the CPU runs in seconds.

`make_root(tmp)` copies `BENCHMARK.json` and `bench/` into `tmp` and adds
the configuration `tiny` (6 x 12 x 10, 4 members) and, for each real
cell, a cell `tiny.<cell>` with that cell's op, a 5-step mix of two pool
states, that cell's own limits and its metrics, so the check runs as on
the card.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def make_root(tmp) -> Path:
    tmp = Path(tmp)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp / "bench/configs/nero256.json").read_text())
    cfg.update(name="tiny", nz=6, ny=12, nx=10, members=4)
    (tmp / "bench/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "bench/configs/tiny.json",
                             "reduced": ["nz", "ny", "nx", "members"],
                             "why": "CPU tests"})
    for w in list(bench["workloads"]):
        op = json.loads((tmp / "bench/traffic" / f"{w['traffic']}.json")
                        .read_text())["op"]
        name = f"tiny.{w['name']}"
        mix = {"kind": "forecast_runs", "op": op, "steps_per_forecast": 5,
               "pool_gib": 3.2e-4}
        (tmp / "bench/traffic" / f"tiny_{w['name']}.json").write_text(
            json.dumps(mix))
        shutil.copy(tmp / "bench/limits" / f"{w['name']}.json",
                    tmp / "bench/limits" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": f"tiny_{w['name']}",
                                   "chips": 1, "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def real_cells():
    return [w["name"] for w in
            json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
