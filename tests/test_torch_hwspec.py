"""The port's hardware specs, tile planner, performance model and autotuner
against the JAX package's.

Both packages load the same three spec files (the port ships copies, byte
for byte) and run the same float arithmetic over them, so the tile spaces,
the tuned plans, their Pareto fronts and the modelled estimates agree to
`rel=1e-12`, and `model_by_hardware` gives the JAX package's table plus an
`h100_sxm` row. The port's default spec is its own `h100_sxm`.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.core import autotune as jautotune
from repro.core import hwspec as jhwspec
from repro.core import perfmodel as jperfmodel
from repro.core import tiling as jtiling
from repro.weather.program import StencilProgram as JProgram
from repro.weather.program import compile as jcompile
from repro_torch.core import autotune, hierarchy, hwspec, perfmodel, tiling
from repro_torch.weather.program import KNOWN_HARDWARE, StencilProgram, compile

SHARED = ("tpu_v5e", "power9", "nero_ad9h7")
REL = 1e-12
EST_FIELDS = ("compute_s", "memory_s", "collective_s", "vmem_s", "time_s",
              "gflops", "energy_j")


# ---------------------------------------------------------------- loading

@pytest.mark.parametrize("name", SHARED)
def test_shared_specs_match_the_jax_package(name):
    with open(os.path.join(jhwspec.spec_dir(), f"{name}.json"), "rb") as a, \
            open(os.path.join(hwspec.spec_dir(), f"{name}.json"), "rb") as b:
        assert a.read() == b.read()
    got, want = hwspec.load_spec(name), jhwspec.load_spec(name)
    assert got.fingerprint == want.fingerprint
    assert got.describe() == want.describe()
    assert got.hierarchy().vmem.capacity_bytes == \
        want.hierarchy().vmem.capacity_bytes
    assert hwspec.load_spec(name) is got          # cached


def test_available_specs_are_the_shared_ones_and_the_h100():
    assert hwspec.available_specs() == tuple(sorted(SHARED + ("h100_sxm",)))
    assert KNOWN_HARDWARE == hwspec.available_specs()


def test_h100_spec_loads_and_is_the_default(monkeypatch):
    monkeypatch.delenv("REPRO_HWSPEC", raising=False)
    assert hwspec.default_spec_name() == "h100_sxm"
    spec = hwspec.default_spec()
    assert spec.name == "h100_sxm" and len(spec.fingerprint) == 12
    # data-sheet values
    assert spec.main.bandwidth_bytes_per_s == 3.35e12
    assert spec.near.capacity_bytes == tiling.SMEM_BYTES_PER_BLOCK
    assert spec.peak_flops == {"bfloat16": 989e12, "float32": 67e12}
    assert spec.peak_watts == 700.0
    assert all(c.watts == 700.0 for c in spec.kernel_classes.values())
    assert spec.card == "H100"
    assert hierarchy.h100_sxm() == spec.hierarchy()
    assert hierarchy.VPU_LANES == \
        hwspec.load_spec("tpu_v5e").layout["vpu_lanes"]
    monkeypatch.setenv("REPRO_HWSPEC", "power9")
    assert hwspec.default_spec_name() == "power9"
    assert hwspec.default_spec().jax_backend == "cpu"


def test_fingerprint_is_content_hash(tmp_path):
    with open(os.path.join(hwspec.spec_dir(), "power9.json")) as fh:
        d = json.load(fh)
    with open(tmp_path / "power9.json", "w") as fh:
        json.dump(d, fh)
    copy = hwspec.load_spec("power9", directory=str(tmp_path))
    assert copy.fingerprint == hwspec.load_spec("power9").fingerprint
    d["idle_watts"] = 61.0
    with open(tmp_path / "tweaked.json", "w") as fh:
        json.dump(dict(d, name="tweaked"), fh)
    tweaked = hwspec.load_spec("tweaked", directory=str(tmp_path))
    assert tweaked.fingerprint != copy.fingerprint
    with open(tmp_path / "mismatch.json", "w") as fh:
        json.dump({"name": "other"}, fh)
    with pytest.raises(hwspec.SpecValidationError):
        hwspec.load_spec("mismatch", directory=str(tmp_path))


# ------------------------------------------------------------- validation

def _valid_dict():
    with open(os.path.join(hwspec.spec_dir(), "tpu_v5e.json")) as fh:
        return json.load(fh)


def _level(d, role):
    return next(e for e in d["memory_levels"] if e["role"] == role)


@pytest.mark.parametrize("breakage,field", [
    (lambda d: d.pop("peak_flops"), "peak_flops"),
    (lambda d: d["memory_levels"].remove(_level(d, "main")),
     "memory_levels"),
    (lambda d: _level(d, "main").pop("bandwidth_bytes_per_s"),
     "bandwidth_bytes_per_s"),
    (lambda d: _level(d, "near").__setitem__("capacity_bytes", -1),
     "capacity_bytes"),
    (lambda d: d["kernel_classes"]["streaming"].__setitem__(
        "bw_utilization", 1.5), "kernel_classes.streaming.bw_utilization"),
    (lambda d: d["collective"].pop("latency_s"), "collective.latency_s"),
    (lambda d: d.__setitem__("schema_version", 99), "schema_version"),
    (lambda d: d.__setitem__("idle_watts", 1e6), "idle_watts"),
    (lambda d: d["kernel_classes"]["solver"].__setitem__("watts", -3.0),
     "kernel_classes.solver.watts"),
    (lambda d: d.__setitem__("jax_backend", 7), "jax_backend"),
])
def test_validation_names_the_same_field(breakage, field):
    d = _valid_dict()
    breakage(d)
    with pytest.raises(jhwspec.SpecValidationError) as want:
        jhwspec.spec_from_dict(d, where="test")
    with pytest.raises(hwspec.SpecValidationError) as got:
        hwspec.spec_from_dict(d, where="test")
    assert field in str(got.value)
    assert str(got.value) == str(want.value)


def test_card_must_be_a_string():
    d = dict(_valid_dict(), card=3)
    with pytest.raises(hwspec.SpecValidationError, match="'card'"):
        hwspec.spec_from_dict(d, where="test")


def test_kernel_class_names():
    assert hwspec.kernel_class_name(tiling.HDIFF) == "streaming"
    assert hwspec.kernel_class_name(tiling.COPY) == "streaming"
    assert hwspec.kernel_class_name(tiling.VADVC) == "solver"
    with pytest.raises(KeyError):
        hwspec.kernel_class_name("warp")


@pytest.mark.parametrize("dtype,nbytes", [
    ("float32", 4), ("bfloat16", 2), (torch.float32, 4), (torch.bfloat16, 2),
    ("float16", 2)])
def test_dtype_bytes(dtype, nbytes):
    assert hwspec.dtype_bytes(dtype) == nbytes


def test_execution_fidelity_on_the_cpu():
    fid = hwspec.execution_fidelity(device="cpu")
    assert fid["spec"] == hwspec.default_spec_name()
    assert fid["spec_fingerprint"] == hwspec.default_spec().fingerprint
    assert fid["device"] == "cpu" and fid["card"] is None
    assert fid["plain_versions"] and not fid["walltime_trustworthy"]


# ------------------------------------------------ planner and model parity

def _approx(a, b):
    return a == pytest.approx(b, rel=REL, abs=0.0)


@pytest.mark.parametrize("spec_name", SHARED)
@pytest.mark.parametrize("op", ["hdiff", "vadvc", "copy", "lru_scan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid", [(8, 64, 64), (64, 256, 256)])
def test_tile_space_tune_and_estimate_match(spec_name, op, dtype, grid):
    jspec, spec = jhwspec.load_spec(spec_name), hwspec.load_spec(spec_name)
    jop, top = jautotune.get_op(op), autotune.get_op(op)
    assert top == tiling.OpSpec(**vars(jop))
    want = jtiling.candidate_tiles(jop, grid, dtype, jspec.hierarchy())
    got = tiling.candidate_tiles(top, grid, dtype, spec.hierarchy())
    assert [p.tile for p in got] == [p.tile for p in want]
    assert [p.vmem_bytes for p in got] == [p.vmem_bytes for p in want]
    assert [p.describe() for p in got[:8]] == [p.describe() for p in want[:8]]

    jt = jautotune.tune(jop, grid, dtype, spec=jspec)
    tt = autotune.tune(top, grid, dtype, spec=spec)
    assert tt.plan.tile == jt.plan.tile and tt.plan.dtype == jt.plan.dtype
    assert len(tt.pareto) == len(jt.pareto)
    for (t1, m1), (t2, m2) in zip(tt.pareto, jt.pareto):
        assert _approx(t1, t2) and m1 == m2
    for field in EST_FIELDS:
        assert _approx(getattr(tt.est, field), getattr(jt.est, field)), field
    assert tt.est.bottleneck == jt.est.bottleneck
    assert (tt.est.hardware, tt.est.kernel_class) == \
        (jt.est.hardware, jt.est.kernel_class)
    assert _approx(tt.est.gflops_per_watt, jt.est.gflops_per_watt)

    # the model on a plan that is not the pick, and its roofline share
    jplan, plan = want[len(want) // 2], got[len(got) // 2]
    je, te = (jperfmodel.estimate(jplan, spec=jspec),
              perfmodel.estimate(plan, spec=spec))
    for field in EST_FIELDS:
        assert _approx(getattr(te, field), getattr(je, field)), field
    assert _approx(perfmodel.roofline_fraction(te),
                   jperfmodel.roofline_fraction(je))


def test_zero_time_and_zero_flop_estimates():
    import dataclasses
    spec = hwspec.load_spec("h100_sxm")
    est = perfmodel.estimate(
        autotune.tune(tiling.COPY, (8, 128, 128), "float32").plan, spec=spec)
    assert est.gflops == 0.0 and est.bottleneck == "memory"
    assert 0.0 < perfmodel.roofline_fraction(est) <= 1.0
    zero = dataclasses.replace(est, time_s=0.0)
    assert perfmodel.roofline_fraction(zero) == 0.0
    hd = perfmodel.estimate(
        autotune.tune(tiling.HDIFF, (8, 128, 128), "float32").plan)
    assert perfmodel.gflops_per_watt(hd) > 0.0
    assert perfmodel.gflops_per_watt(dataclasses.replace(hd, time_s=0.0)) \
        == 0.0


def test_h100_model_uses_the_board_limit_as_power():
    spec = hwspec.load_spec("h100_sxm")
    tuned = autotune.tune(tiling.VADVC, (64, 256, 256), "float32", spec=spec)
    est = tuned.est
    assert est.hardware == "h100_sxm" and est.kernel_class == "solver"
    assert est.energy_j / est.time_s == pytest.approx(700.0)


def test_measure_walltime_on_the_cpu():
    calls = []
    t = autotune.measure_walltime(lambda: calls.append(1), repeats=3)
    assert len(calls) == 4 and t >= 0.0


def test_tune_with_a_measure_takes_the_measured_pick():
    grid = (8, 64, 64)
    target = tiling.candidate_tiles(tiling.HDIFF, grid, "float32")[-1]
    tuned = autotune.tune(tiling.HDIFF, grid, "float32",
                          measure=lambda p: 0.0 if p == target else 1.0)
    assert tuned.plan == target
    assert tuned.pareto[0] == (0.0, target.vmem_bytes)


# ------------------------------------------------------ model_by_hardware

def test_model_by_hardware_matches_the_jax_package_and_the_paper():
    grid = (64, 256, 256)
    want = jcompile(JProgram(grid_shape=(4, 16, 16)),
                    interpret=True).model_by_hardware(grid)
    plan = compile(StencilProgram(grid_shape=(4, 16, 16)), device="cpu")
    mbh = plan.model_by_hardware(grid)
    assert mbh is plan.model_by_hardware(grid)               # cached
    for key in ("grid_shape", "dtype", "baseline"):
        assert mbh[key] == want[key]
    assert set(mbh["specs"]) == set(want["specs"]) | {"h100_sxm"}
    for name in want["specs"]:
        assert mbh["specs"][name] == want["specs"][name]
    assert set(mbh["kernels"]) == set(want["kernels"]) == {"hdiff", "vadvc"}
    for kernel, rows in mbh["kernels"].items():
        assert set(rows) == set(want["kernels"][kernel]) | {"h100_sxm"}
        for name, row in want["kernels"][kernel].items():
            for key, value in row.items():
                if isinstance(value, float):
                    assert _approx(rows[name][key], value), (kernel, name, key)
                else:
                    assert rows[name][key] == value
        t_p9 = rows["power9"]["time_us"]
        for name, row in rows.items():
            assert row["speedup_vs_power9"] == pytest.approx(
                t_p9 / row["time_us"], rel=1e-6)
        h100 = rows["h100_sxm"]
        assert h100["time_us"] > 0 and h100["bottleneck"] == "memory"
    # the paper's headline numbers (NERO vs POWER9)
    hd = mbh["kernels"]["hdiff"]["nero_ad9h7"]
    va = mbh["kernels"]["vadvc"]["nero_ad9h7"]
    assert hd["speedup_vs_power9"] == pytest.approx(12.7, rel=0.15)
    assert hd["gflops_per_watt"] == pytest.approx(21.01, rel=0.15)
    assert va["speedup_vs_power9"] == pytest.approx(5.3, rel=0.15)
    assert va["gflops_per_watt"] == pytest.approx(1.61, rel=0.15)
    assert mbh["kernels"]["hdiff"]["power9"]["gflops"] == \
        pytest.approx(58.5, rel=0.05)
    assert mbh["kernels"]["vadvc"]["power9"]["gflops"] == \
        pytest.approx(29.1, rel=0.05)
    assert plan.report()["model_by_hardware"] == plan.model_by_hardware()


def test_program_hardware_field_is_validated_against_the_specs():
    with pytest.raises(ValueError, match="unknown hardware"):
        StencilProgram(grid_shape=(4, 16, 16), hardware="cray1")
    prog = StencilProgram(grid_shape=(4, 16, 16), hardware="h100_sxm")
    assert prog.to_json()["hardware"] == "h100_sxm"
