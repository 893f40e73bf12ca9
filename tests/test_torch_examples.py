"""The port's user entry points, `examples/torch_*.py`, run on the CPU
(`--device cpu`: the kernels' plain versions) at a small size, each in a
subprocess: exit 0 and the example's `OK` line, plus what each one shows
(the weather run's mesh energy equal to its single-device energy, the
chaos run's one quarantined request, the failover drill's bit-for-bit
table, the training run's resume from its checkpoint), and no kernel
launched on the CPU (each prints its launch counts). Without a card the
examples' default device, the card, refuses to run rather than fall back
to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_weather_simulation",
            "torch_forecast_service", "torch_serve_lm", "torch_train_lm")
OK_LINE = {"torch_quickstart": "quickstart OK",
           "torch_weather_simulation": "weather simulation OK",
           "torch_forecast_service": "forecast service OK",
           "torch_serve_lm": "serve_lm OK",
           "torch_train_lm": "train_lm OK"}
WEATHER = ["--device", "cpu", "--grid", "8,16,16", "--steps", "3"]
TRAIN = ["--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "64"]


def _run(name, *args, env=None):
    # two threads a run: the suite's other workers share the cores
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "2", **(env or {})})
    return res


def _ok(name, *args, ok=None):
    res = _run(name, *args)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[-1] == (ok or OK_LINE[name]), res.stdout[-2000:]
    assert lines[-2] == "kernel launches: {}"     # the CPU runs no kernel
    return lines


def test_quickstart_on_the_cpu():
    lines = _ok("torch_quickstart", "--device", "cpu")
    errs = {ln.split(":")[0]: float(ln.rsplit(" ", 1)[1]) for ln in lines
            if "max err" in ln}
    assert errs["plain hdiff_simple vs numpy oracle"] <= 1e-5
    assert errs["plain vadvc vs vadvc_np"] <= 2e-4
    assert any(ln.startswith("vadvc: tridiagonal residual") for ln in lines)
    assert "plan.run(3 steps): finite=True" in lines


@pytest.fixture(scope="module")
def weather():
    """The weather run's stdout lines, on one device and on a (2, 2)
    mesh of four CPU shards."""
    return {mesh: _ok("torch_weather_simulation", *WEATHER,
                      *(["--mesh", mesh] if mesh else []))
            for mesh in ("", "2,2")}


@pytest.mark.parametrize("mesh", ["", "2,2"])
def test_weather_simulation_on_the_cpu(weather, mesh):
    lines = weather[mesh]
    assert any("diffusion dissipates: True" in ln for ln in lines)
    if mesh:
        assert "mesh (2, 2): 4 shards on 1 cpu device(s); listing cpu 4 " \
               "times" in lines
        assert "domain-decomposed over mesh {'data': 2, 'model': 2}" in lines


def test_weather_simulation_mesh_energy_equals_one_device(weather):
    final = {m: [ln for ln in lines if ln.startswith("final field energy")]
             for m, lines in weather.items()}
    assert len(final[""]) == 1 and final[""] == final["2,2"]


@pytest.mark.parametrize("mode", ["plain", "chaos", "kill"])
def test_forecast_service_on_the_cpu(mode):
    args = {"plain": [], "chaos": ["--chaos"],
            "kill": ["--kill-device", "3"]}[mode]
    lines = _ok("torch_forecast_service", "--device", "cpu", *args,
                ok="mesh-failover drill OK" if mode == "kill" else None)
    if mode == "kill":
        assert any(ln.startswith("after:  mesh 2x1") for ln in lines)
        assert "bit for bit: 6 of 6 requests identical to their solo runs " \
               "on the original mesh" in lines
        return
    rows = [ln.split() for ln in lines if ln.split()[-1:] in (["ok"],
                                                              ["failed"])]
    assert len(rows) == 6
    failed = [r for r in rows if r[-1] == "failed"]
    if mode == "chaos":
        assert len(failed) == 1
        assert "chaos: faults_fired=2 quarantined=1 round_retries=1 " \
               "failed=1" in lines
        assert any("diagnosis: validity_guard" in ln for ln in lines)
    else:
        assert not failed


def test_serve_lm_on_the_cpu():
    lines = _ok("torch_serve_lm", "--device", "cpu")
    assert lines[0].startswith("serving reduced gemma3-27b")
    assert any(ln.startswith("6 requests, 72 tokens") for ln in lines)


def test_train_lm_on_the_cpu_and_its_resume(tmp_path):
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt")]
    lines = _ok("torch_train_lm", *TRAIN, *ckpt)
    assert lines[0].startswith("training demo-100m: 129.0M params")
    assert any(ln.startswith("loss: ") and "steps 0..5" in ln
               for ln in lines)
    lines = _ok("torch_train_lm", *TRAIN[:3], "7", *TRAIN[4:], *ckpt)
    assert "[fit] resuming from step 6" in lines
    assert any("steps 6..6" in ln for ln in lines)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_card_unless_asked(name):
    """The default device is the card: without one the example exits
    nonzero and names the CPU option, rather than run there."""
    res = _run(name, env={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "cpu" in (res.stdout + res.stderr)
    assert OK_LINE[name] not in res.stdout
