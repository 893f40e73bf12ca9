"""The correctness check, driven through a whole run on the CPU.

Each real cell has a small twin (`tiny.<cell>`: its op and its limits on a
6 x 12 x 10 grid of 4 members, 5-step forecasts) that `harness.run_cell`
runs past the look for a chip, on the program's plain path. A sound run
passes. With the timed path broken underneath, by each fault such a cell
can have, the run reports `correct` false. The control, the program's
own bfloat16 path in its place, fails every cell's limit.
"""

from __future__ import annotations

import math

import pytest
import torch

from bench import calibrate, manifest
from bench.tests import tiny

CELLS = tiny.real_cells()
KIND = manifest.traffic_kind(manifest.cell(tiny.ROOT, CELLS[0]))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _views(state, pick):
    """A WeatherState whose every leaf is `pick(name of group, leaf)`."""
    from repro_torch.weather.fields import WeatherState
    return WeatherState(
        fields={n: pick("fields", n) for n in state.fields},
        wcon=pick("wcon", None),
        tens={n: pick("tens", n) for n in state.tens},
        stage_tens={n: pick("stage_tens", n) for n in state.stage_tens})


def _leaf(state, group, name):
    return state.wcon if group == "wcon" else getattr(state, group)[name]


def unchanged(wl):
    wl.forecast = lambda state: state


def half_batch(wl):
    def forecast(state):
        out = wl.plan.run(state, wl.steps)
        half = wl.members // 2
        return _views(out, lambda g, n: torch.cat(
            [_leaf(out, g, n)[:half], _leaf(state, g, n)[half:]]))
    wl.forecast = forecast


def altered(wl):
    def forecast(state):
        out = wl.plan.run(state, wl.steps)
        u = out.fields["u"].clone()
        u[:, 0, 0, 0] += 0.5 * float(u.abs().max())
        fields = dict(out.fields, u=u)
        return _views(out, lambda g, n: fields[n] if g == "fields"
                      else _leaf(out, g, n))
    wl.forecast = forecast


def _run(root, cell, hook=None):
    from bench import harness
    return harness.run_cell(root, f"tiny.{cell}", seed=2**31 + 77,
                            seconds=0.05, traced=False, device="cpu",
                            workload_hook=hook)["result"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["check"]) == set(KIND.NUMBERS)
    for check in out["check"].values():
        assert check["value"] <= check["limit"]
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {"gpt_per_s", "setup_s"}  # no peak on CPU


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(root, cell, fault):
    out = _run(root, cell, fault)
    assert out["correct"] is False
    assert out["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(root, cell):
    got = calibrate.readings(root, f"tiny.{cell}", 2**31 + 5, control=True,
                             device="cpu")
    limits = got["limits"]
    assert all(got["program"][k] <= limits[k] for k in KIND.NUMBERS)
    assert any(got["control"][k] > limits[k] for k in KIND.NUMBERS)


def test_judge_holds_every_limit():
    from bench import harness
    limits = {"a": 1.0, "b": 0.5}
    answers = [(0, {"a": 0.5, "b": 0.1}), (3, {"a": 2.0, "b": 0.1})]
    compared, correct, failed = harness.judge(
        {"a": 2.0, "b": 0.1}, answers, limits)
    assert compared == {"a": 2.0, "b": 0.1} and not correct and failed == 1
    compared, correct, failed = harness.judge({"a": 0.5}, [(0, {"a": 0.5})],
                                              limits)
    assert compared["b"] == math.inf and not correct and failed == 1


def test_untraced_forecasts_keep_no_answer(root):
    """The traced stretch's forecasts (`keep=False`) leave the check's
    sample as the window left it, so the trace holds no copy of the
    benchmark's."""
    cell = manifest.cell(root, f"tiny.{CELLS[0]}")
    wl = KIND.Workload(cell, 2**31 + 9, "cpu")
    wl.draw_inputs()
    wl.compile()
    wl.one()
    kept = list(wl.kept)
    wl.one(keep=False)
    wl.one(keep=False)
    assert wl.kept == kept and wl.done == 3


def test_leaf_gaps_scale_and_non_finite():
    e, nf, grid = 2, 4, (3, 4, 5)
    want = {"fields": torch.ones((e, nf) + grid),
            "wcon": torch.full((e,) + grid, 2.0),
            "tens": torch.ones((e, nf) + grid),
            "stage_tens": torch.zeros((e, nf) + grid)}
    got = {k: v.clone() for k, v in want.items()}
    got["stage_tens"][0, 1, 0, 0, 0] = 0.5          # a zero leaf moves
    gaps = KIND.leaf_gaps(got, want)
    assert [len(g) for g in gaps.values()] == [3 * nf + 1] * 2
    assert max(gaps["state_gap"]) == pytest.approx(0.5)  # over the median
    points = e * 3 * 4 * 5
    assert max(gaps["state_rms_gap"]) == pytest.approx(
        0.5 / points ** 0.5, rel=1e-5)
    got["fields"][1, 2, 2, 2, 2] = float("nan")
    assert all(math.isinf(max(g))
               for g in KIND.leaf_gaps(got, want).values())
