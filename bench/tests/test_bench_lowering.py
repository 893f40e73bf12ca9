"""The reader of the op lowering's copy counter
(`metrics/lowering.copy_gib_per_step.py`): bytes over steps of the
program's `LOWERING`, nothing where the program has no such counter (the
program before it had one), and the value a small cell's run on the CPU
leaves."""

from __future__ import annotations

import sys

import pytest

from bench import harness, manifest
from bench.tests import tiny

ROOT = tiny.ROOT
METRIC = "lowering.copy_gib_per_step"
GIB = 2**30


def _read(root=ROOT):
    return manifest.reader(root, METRIC).read(None)


@pytest.mark.parametrize("counter,want", [
    # two rounds of k = 2: bytes over steps, not rounds
    ({"rounds": 2, "steps": 4, "copies": 9, "bytes": 3 * GIB}, 0.75),
    ({"rounds": 5, "steps": 5, "copies": 0, "bytes": 0}, 0.0),
    ({"rounds": 0, "steps": 0, "copies": 0, "bytes": 0}, None)],
    ids=["k2", "no_copy", "no_round"])
def test_copy_reader(monkeypatch, counter, want):
    from repro_torch.core import spans
    monkeypatch.setattr(spans, "LOWERING", counter)
    assert _read() == want


def test_copy_reader_says_nothing_without_the_counter(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    assert _read() is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _hdiff_bounds(cfg):
    """A one-step round's bytes: the wrap pad's two cats every round, and
    the re-stack on every round but a forecast's first."""
    halo, item = 2, 4
    planes = cfg["members"] * len(cfg["fields"]) * cfg["nz"]
    ny, nx = cfg["ny"], cfg["nx"]
    pad = planes * (ny + 2 * halo) * (nx + (nx + 2 * halo)) * item
    stack = planes * ny * nx * item
    return pad, pad + stack


@pytest.mark.parametrize("cell", ["cosmo_e.hdiff", "cosmo_e.vadvc"])
def test_copy_reader_after_a_run(root, cell):
    from repro_torch.core import spans
    spans.reset_lowering()
    harness.run_cell(root, f"tiny.{cell}", seed=2**31 + 91, seconds=0.05,
                     traced=False, device="cpu")
    assert spans.LOWERING["rounds"] == spans.LOWERING["steps"] > 0
    got = _read(root) * GIB
    if cell == "cosmo_e.vadvc":
        assert got == 0.0
    else:
        cfg = manifest.cell(root, f"tiny.{cell}").config
        lo, hi = _hdiff_bounds(cfg)
        assert lo < got < hi
