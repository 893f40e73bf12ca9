"""The port's planner against the JAX package's: the k-step resolver, the
model's windows, `report()`'s `traffic` and `model` blocks,
`compile(hardware=...)`, and `compile(tune="measure")` with its disk cache.

Numbers are held to the JAX package's at `rel=1e-12` where both compute
the same model: `plan_k_steps` under one shared spec, `report()["traffic"]`
at the port plan's `traffic_model_ty` (the rows of the kernel tile that
runs), and `report()["model"]` with `REPRO_HWSPEC=tpu_v5e` in both
packages, so both tune the same window. The k-step legality differs by
design: the port's is the CUDA k-step kernel's tile (nz <= 64). The
measured mode runs here on the CPU: it times the candidate tiles, stores
the pick, and a second process reads it back and measures nothing.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import autotune as jautotune
from repro.core import hwspec as jhwspec
from repro.core import memmodel as jmemmodel
from repro.core import tiling as jtiling
from repro.kernels.dycore_fused import ops as jfused_ops
from repro.kernels.hadv import ops as jhadv_ops
from repro.kernels.hdiff import ops as jhdiff_ops
from repro.kernels.vadvc import ops as jvadvc_ops
from repro.weather.program import StencilProgram as JProgram
from repro.weather.program import compile as jcompile
from repro_torch.core import autotune, hwspec, tiling
from repro_torch.kernels import _build
from repro_torch.kernels.dycore_fused import ops as fused_ops
from repro_torch.kernels.hadv import ops as hadv_ops
from repro_torch.kernels.hdiff import ops as hdiff_ops
from repro_torch.kernels.vadvc import ops as vadvc_ops
from repro_torch.weather import fields
from repro_torch.weather.program import (StencilProgram, compile,
                                         plan_cache_key)
from repro_torch.weather.stencil_ops import get_stencil_op

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12
GRID, E = (4, 16, 16), 2
SHARED = ("tpu_v5e", "power9", "nero_ad9h7")
# (op, variant, k_steps) of every kernelled plan, and the unfused oracles
PLANS = [("dycore", "whole_state", 1), ("dycore", "per_field", 1),
         ("dycore", "kstep", 2), ("hdiff", "whole_state", 1),
         ("hdiff", "per_field", 1), ("hdiff", "kstep", 2),
         ("vadvc", "whole_state", 1), ("vadvc", "per_field", 1),
         ("hadv_upwind", "whole_state", 1)]
ORACLES = [("dycore", "unfused", 1), ("hdiff", "unfused", 1),
           ("vadvc", "unfused", 1), ("hadv_upwind", "unfused", 1)]
MODEL_KEYS = ("time_us", "gflops", "gflops_per_watt", "bottleneck",
              "hardware", "kernel_class", "spec_fingerprint")


@pytest.fixture
def v5e(monkeypatch):
    """Both packages model under `tpu_v5e`."""
    monkeypatch.setenv("REPRO_HWSPEC", "tpu_v5e")


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh tuning cache; the counters from zero."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    monkeypatch.setattr(autotune, "TUNE_CACHE_STATS",
                        {"hits": 0, "misses": 0, "stores": 0})
    return tmp_path


def _programs(op, variant, k, **kw):
    kw = dict(grid_shape=GRID, ensemble=E, op=op, variant=variant,
              k_steps=k, **kw)
    return StencilProgram(**kw), JProgram(**kw)


def _approx(got, want):
    return got == pytest.approx(want, rel=REL, abs=0.0)


def _assert_same(got, want, path="out"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_same(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, float):
        assert _approx(got, want), path
    else:
        assert got == want, path


# ------------------------------------------------------------ snapping

def test_snap_to_divisor_matches_the_jax_package():
    for n in (1, 7, 12, 16, 20, 36, 257):
        for t in range(0, n + 3):
            for lo in (1, 2, 3):
                assert tiling.snap_to_divisor(t, n, lo) == \
                    jtiling.snap_to_divisor(t, n, lo)


# ------------------------------------------------------------ k-step depth

@pytest.mark.parametrize("grid", [(4, 16, 16), (4, 32, 32), (80, 64, 64)])
@pytest.mark.parametrize("shards", [(1, 2), (2, 2), (2, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_k_steps_matches(grid, shards, dtype):
    got = autotune.plan_k_steps(grid, dtype, shards,
                                spec=hwspec.load_spec("tpu_v5e"))
    want = jautotune.plan_k_steps(grid, dtype, shards,
                                  spec=jhwspec.load_spec("tpu_v5e"))
    assert got == want
    # the generic exchange model of hdiff's rides and flops, too
    op = get_stencil_op("hdiff")
    prog = StencilProgram(grid_shape=grid, op="hdiff", dtype=dtype)
    model = lambda k: op.exchange_model(prog, k, shards)
    jmodel = lambda k: jmemmodel.packed_exchange_model(
        grid, dtype, rides=op.memmodel_rides(4), k=k, shards=shards,
        compute_halo=(2 * k, 2 * k))
    kw = dict(n_fields=4, halo=2, flops_per_point=op.flops_per_point)
    assert autotune.plan_k_steps(
        grid, dtype, shards, exchange_model=model,
        spec=hwspec.load_spec("tpu_v5e"), **kw) == jautotune.plan_k_steps(
        grid, dtype, shards, exchange_model=jmodel,
        spec=jhwspec.load_spec("tpu_v5e"), **kw)


@pytest.mark.parametrize("grid", [(4, 16, 16), (4, 32, 32)])
@pytest.mark.parametrize("shards", [(1, 2), (2, 2), (2, 4)])
def test_resolve_k_steps_matches_where_both_checks_accept(grid, shards):
    v5e, jv5e = hwspec.load_spec("tpu_v5e"), jhwspec.load_spec("tpu_v5e")
    prog = StencilProgram(grid_shape=grid)
    got = autotune.resolve_k_steps(
        grid, "float32", shards, spec=v5e,
        kstep_check=get_stencil_op("dycore").kstep_check(prog, shards))
    assert got == autotune.resolve_k_steps(grid, "float32", shards,
                                           spec=v5e)
    assert got == jautotune.resolve_k_steps(grid, "float32", shards,
                                            spec=jv5e)
    # hdiff: its stream takes every k, as the JAX package's window does
    hprog = StencilProgram(grid_shape=grid, op="hdiff")
    assert autotune.resolve_k_steps(
        grid, "float32", shards, spec=v5e, kstep_check=get_stencil_op(
            "hdiff").kstep_check(hprog, shards)) == \
        autotune.plan_k_steps(grid, "float32", shards, spec=v5e)


def test_resolve_k_steps_is_the_cuda_kstep_kernels_legality():
    """At nz = 80 the JAX package's VMEM check takes k = 3; the CUDA k-step
    kernel's register arrays hold 64 levels, so the port walks down to 1."""
    grid, shards = (80, 32, 32), (2, 2)
    want = jautotune.resolve_k_steps(grid, "float32", shards,
                                     spec=jhwspec.load_spec("tpu_v5e"))
    assert want == 3
    assert autotune.plan_k_steps(grid, "float32", shards,
                                 spec=hwspec.load_spec("tpu_v5e")) == want
    assert autotune.resolve_k_steps(grid, "float32", shards,
                                    spec=hwspec.load_spec("tpu_v5e")) == 1
    check = autotune.dycore_kstep_check(grid, shards)
    with pytest.raises(ValueError, match="nz=80"):
        check(2)


# ------------------------------------------------------------ the model's windows

@pytest.mark.parametrize("grid", [(4, 16, 16), (4, 20, 20), (3, 64, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_windows_match_the_jax_planners(v5e, grid, dtype):
    for variant, k in (("per_field", 1), ("whole_state", 1), ("kstep", 2)):
        assert fused_ops.resolve_tile(variant, grid, dtype, 4, k) == \
            jfused_ops.resolve_tile(variant, grid, dtype, 4, k)
    assert fused_ops.resolve_tile("unfused", grid, dtype, 4) is None
    for port, ref in ((hdiff_ops, jhdiff_ops), (vadvc_ops, jvadvc_ops),
                      (hadv_ops, jhadv_ops)):
        assert port.plan_tile(grid, dtype) == ref.plan_tile(grid, dtype)
        assert port.resolve_tile(grid, dtype).describe() == \
            ref.resolve_tile(grid, dtype).describe()


def test_model_window_falls_back_where_no_window_fits(monkeypatch):
    """Under the H100's 227 KB no whole z-by-x dycore slab fits: the window
    takes the kernel's default rows, snapped; the plan still compiles and
    reports a model."""
    monkeypatch.delenv("REPRO_HWSPEC", raising=False)
    grid = (64, 256, 256)
    with pytest.raises(ValueError, match="no legal tile"):
        autotune.tune(tiling.dycore_whole_state_spec(4), grid, "float32")
    assert fused_ops.plan_tile_whole_state(grid, "float32", 4) == \
        fused_ops.snap_ty(tiling.dycore_default(4)[0], 256)
    assert fused_ops.plan_tile_kstep(grid, "float32", 4, 2) == \
        tiling.snap_ty_kstep(tiling.dycore_kstep_default(2)[0], 256, 2)
    plan = compile(StencilProgram(grid_shape=grid, ensemble=4),
                   device="cpu")
    model = plan.report()["model"]
    assert model["hardware"] == "h100_sxm" and model["time_us"] > 0


# ------------------------------------------------------------ report()

@pytest.mark.parametrize("op,variant,k", PLANS + ORACLES)
def test_report_traffic_matches_the_jax_hook(v5e, op, variant, k):
    prog, jprog = _programs(op, variant, k)
    plan = compile(prog, device="cpu")
    rep = plan.report()
    json.dumps(rep)
    ty = rep["traffic_model_ty"]
    assert ty == (plan.tile_ty if plan.tile is not None else compile(
        StencilProgram(grid_shape=GRID, ensemble=E, op=op),
        device="cpu").tile_ty)
    jplan = jcompile(jprog, interpret=True)
    _assert_same(rep["traffic"], jplan.op_def.traffic(jplan, ty))
    assert rep["exchange_model"] is None


@pytest.mark.parametrize("hardware", SHARED)
@pytest.mark.parametrize("op,variant,k", PLANS)
def test_report_model_matches_the_jax_package(v5e, hardware, op, variant, k):
    prog, jprog = _programs(op, variant, k, hardware=hardware)
    plan = compile(prog, device="cpu")
    jplan = jcompile(jprog, interpret=True)
    assert plan.model_window().describe() == jplan.tile_plan.describe()
    got = plan.report()["model"]
    want = jplan.report()["model"]
    assert set(got) == set(MODEL_KEYS) == set(want)
    for key in MODEL_KEYS:
        if isinstance(want[key], float):
            assert _approx(got[key], want[key]), key
        else:
            assert got[key] == want[key], key
    assert got["hardware"] == hardware
    assert got["spec_fingerprint"] == hwspec.load_spec(hardware).fingerprint


@pytest.mark.parametrize("op,variant,k", ORACLES)
def test_report_model_is_none_for_the_oracle(op, variant, k):
    rep = compile(_programs(op, variant, k)[0], device="cpu").report()
    assert rep["model"] is None and rep["tuning"] is None
    assert rep["traffic"]["stream"] > 0 if op != "dycore" else \
        rep["traffic"]["unfused"]["total"] > 0


def test_hardware_changes_only_the_modelled_numbers():
    base = compile(StencilProgram(grid_shape=GRID, ensemble=E), device="cpu")
    p9 = compile(StencilProgram(grid_shape=GRID, ensemble=E,
                                hardware="power9"), device="cpu")
    assert p9.hardware == "power9" and base.hardware == "h100_sxm"
    assert p9.hardware_spec() is hwspec.load_spec("power9")
    assert p9.tile == base.tile and p9.variant == base.variant
    a, b = base.report(), p9.report()
    assert a["traffic"] == b["traffic"]
    assert b["model"]["hardware"] == "power9"
    assert b["model"]["spec_fingerprint"] == \
        hwspec.load_spec("power9").fingerprint
    assert a["model"]["time_us"] != b["model"]["time_us"]


def test_plan_cache_key_rebinds_only_the_ensemble():
    prog = StencilProgram(grid_shape=GRID, ensemble=E)
    assert plan_cache_key(prog) is prog
    assert plan_cache_key(prog, E) is prog
    four = plan_cache_key(prog, 4)
    assert four.ensemble == 4 and four.grid_shape == GRID
    assert hash(four) == hash(StencilProgram(grid_shape=GRID, ensemble=4))


# ------------------------------------------------------------ tune="measure"

def test_tune_cache_key_depends_on_spec_backend_and_program():
    v5e, h100 = hwspec.load_spec("tpu_v5e"), hwspec.load_spec("h100_sxm")
    prog = StencilProgram(grid_shape=GRID)
    k1 = autotune.tune_cache_key((prog, (1, 1)), h100, "cpu")
    assert k1 == autotune.tune_cache_key((prog, (1, 1)), h100, "cpu")
    assert k1 != autotune.tune_cache_key((prog, (1, 1)), v5e, "cpu")
    assert k1 != autotune.tune_cache_key(
        (prog, (1, 1)), h100, "NVIDIA H100 80GB HBM3 cuda 12.8")
    assert k1 != autotune.tune_cache_key(
        (StencilProgram(grid_shape=GRID, op="hdiff"), (1, 1)), h100, "cpu")
    assert autotune.backend_name("cpu") == "cpu"


def test_tune_cache_dir_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    assert autotune.tune_cache_dir() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "tune")
    assert autotune.tune_cache_dir() != jautotune.tune_cache_dir()


@pytest.mark.parametrize("op,variant,k", PLANS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_candidate_request_pins_its_tile(op, variant, k, dtype):
    """Every candidate's request compiles to its tile (the default's to the
    default tile), the tiles are distinct, and a pinned plan's CPU step
    equals the default plan's bit for bit."""
    prog = _programs(op, variant, k, dtype=dtype)[0]
    plan = compile(prog, device="cpu")
    cands = plan.op_def.cuda_tile_candidates(
        plan.variant, plan.compute_grid, dtype, prog.n_fields, plan.k_steps)
    assert cands[0][1] == plan.tile
    assert len({tile for _, tile in cands}) == len(cands)
    st = fields.initial_state(torch.Generator().manual_seed(0), GRID, E,
                              dtype=dtype, device="cpu")
    want = plan.step(st)
    for request, tile in cands:
        pinned = compile(prog, device="cpu", _tile=request)
        assert pinned.tile == tile
        got = pinned.step(st)
        for n in want.fields:
            assert torch.equal(got.fields[n], want.fields[n])
            assert torch.equal(got.stage_tens[n], want.stage_tens[n])


def test_candidates_at_the_main_path_shapes():
    """At (64, 256, 256) and ensemble 4 each op times several distinct
    tiles, the default first; requests a planner refuses are dropped."""
    want = {("dycore", "whole_state", 1): 6, ("dycore", "kstep", 2): 5,
            ("hdiff", "whole_state", 1): 12, ("vadvc", "whole_state", 1): 6,
            ("hadv_upwind", "whole_state", 1): 9}
    for (op, variant, k), n in want.items():
        plan = compile(StencilProgram(grid_shape=(64, 256, 256), ensemble=4,
                                      op=op, variant=variant, k_steps=k),
                       device="cpu")
        cands = plan.op_def.cuda_tile_candidates(
            variant, plan.compute_grid, "float32", 4, k)
        assert cands[0][1] == plan.tile, op
        assert len(cands) == n, (op, [t for t, _ in cands])


@pytest.mark.parametrize("op,variant,k", PLANS)
def test_measure_picks_a_timed_candidate_and_caches_it(cache, monkeypatch,
                                                       op, variant, k):
    prog = _programs(op, variant, k)[0]
    calls = []
    real = autotune.measure_walltime

    def spy(fn, repeats=3, device="cpu"):
        calls.append(device)
        return real(fn, repeats=1, device=device)
    monkeypatch.setattr(autotune, "measure_walltime", spy)
    plan = compile(prog, device="cpu", tune="measure")
    tuning = plan.report()["tuning"]
    n = len(plan.op_def.cuda_tile_candidates(
        plan.variant, plan.compute_grid, prog.dtype, prog.n_fields, k))
    assert len(calls) == min(n, 8) == len(tuning["measured"])
    assert tuning["cached"] is False and tuning["backend"] == "cpu"
    assert f"{plan.tile.ty}x{plan.tile.tx}" == tuning["kernel_tile"]
    assert tuning["measured_s"] == min(tuning["measured"].values())
    assert autotune.TUNE_CACHE_STATS == {"hits": 0, "misses": 1,
                                         "stores": 1}
    again = compile(prog, device="cpu", tune="measure")
    assert len(calls) == min(n, 8)                 # measured nothing
    assert again.tile == plan.tile
    assert again.report()["tuning"]["cached"] is True
    assert autotune.TUNE_CACHE_STATS["hits"] == 1
    json.dumps(again.report())
    # the unfused oracle has no tile: nothing measured, nothing stored
    oracle = compile(_programs(op, "unfused", 1)[0], device="cpu",
                     tune="measure")
    assert oracle.tile is None and len(calls) == min(n, 8)


def test_measure_lets_a_kernel_failure_propagate(cache, monkeypatch):
    """A candidate that fails to build or launch fails the compile: it is
    not scored `inf`, and nothing is stored."""
    def broken(fn, repeats=3, device="cpu"):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(autotune, "measure_walltime", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        compile(StencilProgram(grid_shape=GRID, ensemble=E), device="cpu",
                tune="measure")
    assert list(cache.iterdir()) == []


def test_measure_scores_a_refused_request_inf(cache, monkeypatch):
    """Only the planner's ValueError for an illegal request scores `inf`;
    the others are timed and the pick is a legal one."""
    from repro_torch.weather import stencil_ops

    op = get_stencil_op("hdiff")
    bad = (0, 0)

    def candidates(*args):
        cands = op.cuda_tile_candidates(*args)
        tile = cands[0][1]
        return cands + [(bad, dataclasses.replace(tile, ty=tile.ty + 1))]

    def resolve(*args):
        if args[-1] == bad:
            raise ValueError("illegal request")
        return op.resolve_tile(*args)
    monkeypatch.setitem(stencil_ops.STENCIL_OPS, "hdiff", dataclasses.replace(
        op, cuda_tile_candidates=candidates, resolve_tile=resolve))
    plan = compile(StencilProgram(grid_shape=GRID, ensemble=E, op="hdiff"),
                   device="cpu", tune="measure")
    tuning = plan.report()["tuning"]
    assert tuning["tile"] != list(bad)
    assert tuning["measured"][tuning["kernel_tile"]] < float("inf")
    assert sorted(tuning["measured"].values())[-1] == float("inf")


_TUNE_SNIPPET = r"""
import json
from repro_torch.core import autotune
calls = {"n": 0}
_real = autotune.measure_walltime
def _spy(fn, repeats=3, device="cpu"):
    calls["n"] += 1
    return _real(fn, repeats=1, device=device)
autotune.measure_walltime = _spy
from repro_torch.weather import program as P
plan = P.compile(P.StencilProgram(grid_shape=(4, 16, 16), ensemble=2),
                 device="cpu", tune="measure")
print("TUNE=" + json.dumps({"tile": [plan.tile.ty, plan.tile.tx],
                            "request": plan.report()["tuning"]["tile"],
                            "measure_calls": calls["n"],
                            "stats": autotune.TUNE_CACHE_STATS}))
"""


def _tune_subprocess(cache_dir):
    env = dict(os.environ, REPRO_TUNE_CACHE=str(cache_dir),
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _TUNE_SNIPPET], env=env,
                       capture_output=True, text=True, timeout=300)
    for line in r.stdout.splitlines():
        if line.startswith("TUNE="):
            return json.loads(line[len("TUNE="):])
    raise AssertionError(f"tune subprocess failed: {r.stderr[-2000:]}")


def test_measured_tune_persistent_cache_across_processes(tmp_path):
    first = _tune_subprocess(tmp_path)
    assert first["measure_calls"] > 0
    assert first["stats"] == {"hits": 0, "misses": 1, "stores": 1}
    second = _tune_subprocess(tmp_path)
    assert second["measure_calls"] == 0          # no re-measurement
    assert second["stats"] == {"hits": 1, "misses": 0, "stores": 0}
    assert second["tile"] == first["tile"]
    assert second["request"] == first["request"]
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    entry = json.loads(files[0].read_text())
    assert entry["backend"] == "cpu" and entry["spec"] == "h100_sxm"
    assert entry["spec_fingerprint"] == \
        hwspec.load_spec("h100_sxm").fingerprint
    assert entry["k_steps"] == 1 and entry["tile"] == first["request"]


@pytest.mark.cuda
@pytest.mark.parametrize("op,variant,k", [("dycore", "whole_state", 1),
                                          ("dycore", "kstep", 2),
                                          ("hdiff", "whole_state", 1),
                                          ("vadvc", "whole_state", 1),
                                          ("hadv_upwind", "whole_state", 1)])
def test_cuda_measured_pick_is_bit_equal_to_the_default(cache, op, variant,
                                                        k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    grid = (8, 64, 64)
    prog = StencilProgram(grid_shape=grid, ensemble=E, op=op,
                          variant=variant, k_steps=k)
    st = fields.initial_state(torch.Generator(device="cuda").manual_seed(0),
                              grid, E, device="cuda")
    default = compile(prog, device="cuda")
    tuned = compile(prog, device="cuda", tune="measure")
    tuning = tuned.report()["tuning"]
    assert tuning["backend"] == autotune.backend_name("cuda")
    assert tuning["measured_s"] <= tuning["measured"][
        tuning["default_tile"]]
    _build.reset_launches()
    got = tuned.step(st)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    want = default.step(st)
    torch.cuda.synchronize()
    assert launches == dict(_build.LAUNCHES)
    for n in want.fields:
        assert torch.equal(got.fields[n], want.fields[n])
        assert torch.equal(got.stage_tens[n], want.stage_tens[n])
    assert compile(prog, device="cuda", tune="measure").tile == tuned.tile
