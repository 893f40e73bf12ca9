"""The port stands alone: no JAX, no `repro`, in its package (every
module, the training slice's `train/`, `data/`, `kernels/xent/` and
`launch/train.py`, the mesh slice's `weather/domain.py` and
`launch/mesh.py`, the mesh forecast slice's `serve/forecast.py`,
`testing/faults.py` and `kernels/slot_guard/`, and the LM mesh slice's
`parallel/sharding.py`, `parallel/policy.py` and
`parallel/compression.py`, and the dry-run slice's `core/roofline.py`,
`core/op_cost.py` and `launch/dryrun.py` among them), its chip smoke
script or its examples (`examples/torch_*.py`); nor does a dry-run of a
full-width cell in its own process."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax_or_repro(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "for m in ('repro_torch.weather.program', "
            "'repro_torch.train.loop', 'repro_torch.kernels.xent.ops', "
            "'repro_torch.data.synthetic', 'repro_torch.launch.train', "
            "'repro_torch.serve.forecast', 'repro_torch.ckpt.checkpoint', "
            "'repro_torch.testing.faults', 'repro_torch.weather.domain', "
            "'repro_torch.launch.mesh', 'repro_torch.kernels.slot_guard.ops', "
            "'repro_torch.kernels.slot_guard.ref', "
            "'repro_torch.kernels.slot_guard.slot_guard', "
            "'repro_torch.parallel.sharding', 'repro_torch.parallel.policy', "
            "'repro_torch.parallel.compression', "
            "'repro_torch.core.roofline', 'repro_torch.core.op_cost', "
            "'repro_torch.launch.dryrun'):\n"
            "    assert m in sys.modules, m\n")
    res = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_a_dry_run_loads_no_jax(tmp_path):
    """`launch/dryrun.py`'s CLI on a full-width cell (tinyllama-1.1b's
    decode_32k on the (16, 16) fake world) ends `ok` with nothing of JAX or
    the JAX package in its process."""
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun\n"
            f"dryrun.RESULTS_DIR = {str(tmp_path)!r}\n"
            "rc = dryrun.main(['--arch', 'tinyllama-1.1b', '--shape', "
            "'decode_32k', '--mesh', 'single'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert rc == 0 and not bad, (rc, bad)\n")
    res = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["status"] == "ok" and line["mesh"] == "single"
