"""What the benchmark loads: never JAX or the JAX package, and a reference
that takes nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from bench import harness
from bench.tests import tiny

ROOT = tiny.ROOT
PROGRAM = {"repro_torch"}
JAX = set(harness.BANNED)


def _imports(path):
    """Top-level names of every module `path` imports."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("name,banned", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("repro", True), ("repro.weather.program", True),
    ("repro_torch", False), ("repro_torch.weather.program", False),
    ("jaxtyping", False), ("reprox", False)])
def test_whole_name_check(monkeypatch, name, banned):
    monkeypatch.setitem(sys.modules, name, sys)
    assert (name in harness.banned_modules()) is banned


def test_sources_import_no_jax():
    for path in (ROOT / "bench").rglob("*.py"):
        assert not _imports(path) & JAX, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        assert not _imports(path) & (PROGRAM | JAX), path
    code = ("import sys; import bench.reference.stencils; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(PROGRAM | JAX)!r})))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "cosmo_e.vadvc",
         "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
