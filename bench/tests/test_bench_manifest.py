"""`BENCHMARK.json` against the rules its readers hold it to, and the files that
the harness finds by name."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from bench import harness, manifest, peaks
from bench.ops import dycore, hdiff, vadvc
from bench.tests import tiny

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_names_units_and_lines():
    assert set(BENCH) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
        for e in BENCH[kind]:
            assert set(e) - {"workloads"} == KEYS[kind], e["name"]
            assert NAME.match(e["name"]), e["name"]
    for c in BENCH["configs"]:
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]), w["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"])
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert all(LINE.match(w) for w in BENCH["command"])


def test_every_config_has_a_cell_and_every_cell_one_chip():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def _reports(cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


def test_each_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        listed = m.get("workloads", sorted(cells))
        assert listed and set(listed) <= cells
        for cell in listed:
            assert _reports(cell, e2e[m["moves"]]), (m["name"], cell)
    for cell in cells:
        got = manifest.cell(ROOT, cell)
        assert {m["name"] for m in got.metrics["per_layer"]}
        assert len(got.metrics["end_to_end"]) >= 2


def test_every_name_has_its_files():
    for w in BENCH["workloads"]:
        cell = manifest.cell(ROOT, w["name"])
        assert set(cell.limits) == set(manifest.traffic_kind(cell).NUMBERS)
        manifest.op(ROOT, cell.traffic["op"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(manifest.reader(ROOT, m["name"]).read)


def test_additions_are_found_without_edits(tmp_path):
    """A configuration, a mix, a cell, its limits and a per-layer metric
    added as new files and entries, in a copy, with no file edited but
    `BENCHMARK.json`."""
    root = tmp_path
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((ROOT / "bench/configs/nero256.json").read_text())
    cfg.update(name="nero128", ny=128, nx=128)
    (root / "bench/configs/nero128.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/hdiff_short.json").write_text(json.dumps(
        {"kind": "forecast_runs", "op": "hdiff", "steps_per_forecast": 20,
         "pool_gib": 1}))
    (root / "bench/limits/nero128.hdiff_short.json").write_text(
        json.dumps({"state_gap": {"limit": 1e-4},
                    "state_rms_gap": {"limit": 1e-5}}))
    (root / "bench/metrics/forecasts_per_s.py").write_text(
        "def read(run):\n"
        "    return run.window['forecasts'] / run.window['window_s']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "nero128", "source": "a test",
                             "file": "bench/configs/nero128.json",
                             "reduced": ["ny", "nx"], "why": "a test"})
    bench["workloads"].append({"name": "nero128.hdiff_short",
                               "config": "nero128",
                               "traffic": "hdiff_short", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("nero128.hdiff_short")
    bench["per_layer"].append({"name": "forecasts_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "plan dispatch", "moves": "gpt_per_s",
                               "workloads": ["nero128.hdiff_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p in (ROOT / "bench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert (root / p.relative_to(ROOT)).read_bytes() == p.read_bytes()

    cell = manifest.cell(root, "nero128.hdiff_short")
    assert cell.config["ny"] == 128 and cell.traffic["steps_per_forecast"] == 20
    assert cell.limits == {"state_gap": 1e-4, "state_rms_gap": 1e-5}
    assert [m["name"] for m in cell.metrics["per_layer"]][-1] == \
        "forecasts_per_s"
    assert {m["name"] for m in cell.metrics["end_to_end"]} == \
        {m["name"] for m in BENCH["end_to_end"]}
    wl = manifest.traffic_kind(cell).Workload(cell, 5, "cpu")
    run = harness.Run(cell=cell, workload=wl, setup_s=1.0,
                      setup_split={}, window={"window_s": 2.0, "forecasts": 6,
                                              "attempted": 6,
                                              "steps": 120, "launches": 120},
                      peak_bytes=2**30)
    assert manifest.reader(root, "forecasts_per_s").read(run) == 3.0
    assert manifest.reader(root, "gpt_per_s").read(run) == pytest.approx(
        cfg["members"] * 64 * 128 * 128 * 60 / 1e9)


def test_end_to_end_metrics_follow_their_cell_lists():
    """An end-to-end metric with a `workloads` list is reported in those
    cells alone; one without it in every cell."""
    for w in BENCH["workloads"]:
        got = {m["name"] for m in manifest.cell(ROOT, w["name"])
               .metrics["end_to_end"]}
        want = {m["name"] for m in BENCH["end_to_end"]
                if _reports(w["name"], m)}
        assert got == want and "setup_s" in got


MIX_KEYS = {"kind", "op", "steps_per_forecast", "pool_gib"}


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (ROOT / "bench/traffic").glob("*.json")))
def test_mixes_hold_only_their_parameters(mix):
    """A mix of `forecast_runs` is data: its kind, its op, N and the pool;
    the check's sample and the warm-up are the kind's constants."""
    got = json.loads((ROOT / "bench/traffic" / f"{mix}.json").read_text())
    assert set(got) == MIX_KEYS and got["kind"] == "forecast_runs"
    assert (ROOT / "bench/ops" / f"{got['op']}.py").is_file()
    assert got["steps_per_forecast"] >= 1 and got["pool_gib"] > 0


def test_bounds_reproduce_the_kernel_table():
    """Step bounds at (4 members, 4 fields, 64, 256, 256) fp32: the whole
    state 0.421 ms and vadvc 0.341 ms (kernel table rows 1 and 4), hdiff
    0.160 ms from the op's own inputs and outputs and 0.165 at the
    kernel's padded shapes (row 3)."""
    grid = (64, 256, 256)

    def ms(op):
        return 1e3 * peaks.bound_s(op.step_bytes(grid, 4, 4, 4),
                                   op.step_flops(grid, 4, 4))
    assert round(ms(dycore), 3) == 0.421
    assert round(ms(vadvc), 3) == 0.341
    assert round(ms(hdiff), 3) == 0.160
    padded = 2 * 4 * 4 * 64 * 260 * 260 * 4
    assert round(1e3 * padded / peaks.HBM_BYTES_PER_S, 3) == 0.165


def test_paths_hold_the_benchmark_only():
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"][1] == "bench/run.py"
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert Path(ROOT / BENCH["command"][1]).is_file()
