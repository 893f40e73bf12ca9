"""The port's single-device plans against the JAX package's, end to end.

For `dycore`, `hdiff`, `vadvc`, `vadvc_update`, `hadv_upwind` and
`asselin` under every ported variant, in float32 and bfloat16, `repro.weather.program.compile(...).step`
and the port's `compile(..., device="cpu").step` advance the same state; the
two are compared step by step for 3 steps, each step from the same input
(the reference's output of the step before), so a flipped limiter branch in
one step cannot spread into the next comparison. Tolerances are the
reference's own per-kernel ones. The k-step plans of `dycore` and `hdiff`
run 5 steps (full rounds and a ragged tail) against the reference's, and
against the port's own whole-state plan. Also: programs round-trip as JSON
across the packages, `report()` keeps the structural keys, the CPU launches
no kernel, the solo `asselin` plan reports where the reference's report
raises, and the option not yet ported (the forecast engine on a mesh)
raises `NotImplementedError`. Mesh plans: `tests/test_torch_mesh.py`;
pipeline programs: `tests/test_torch_pipeline.py`.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.kernels.dycore_fused import ref as jref
from repro.weather import fields as jfields
from repro.weather.program import StencilProgram as JProgram
from repro.weather.program import compile as jcompile
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve.forecast import ForecastEngine
from repro_torch.weather import convert, dycore, fields
from repro_torch.weather.program import StencilProgram, compile

GRID, E = (4, 16, 16), 2
STEPS = 3
LOOSE = 0.05   # |coeff * flux| scale at a flipped limiter branch
PLANS = [("dycore", "whole_state"), ("dycore", "per_field"),
         ("dycore", "unfused"), ("hdiff", "whole_state"),
         ("hdiff", "per_field"), ("hdiff", "unfused"),
         ("vadvc", "whole_state"), ("vadvc", "per_field"),
         ("vadvc", "unfused"), ("vadvc_update", "whole_state"),
         ("vadvc_update", "unfused"), ("hadv_upwind", "whole_state"),
         ("hadv_upwind", "unfused"), ("asselin", "whole_state"),
         ("asselin", "unfused")]
KSTEP_PLANS = [("dycore", 2), ("dycore", 3), ("hdiff", 2), ("hdiff", 3)]
TOL = {"dycore": 1e-5, "hdiff": 1e-5, "vadvc": 2e-4, "vadvc_update": 2e-4,
       "hadv_upwind": 1e-5, "asselin": 1e-5}
STRUCTURAL = ("op", "variant", "k_steps", "local_grid", "compute_grid",
              "pallas_calls_per_round", "collectives_per_round", "footprint")


def _np(a):
    return np.asarray(a)


def _to_port(js, device="cpu"):
    d = lambda m: {k: _np(v) for k, v in m.items()}
    return convert.state_from_numpy(d(js.fields), _np(js.wcon), d(js.tens),
                                    d(js.stage_tens), device=device)


def _as_f32(a):
    """A port array from `state_to_numpy` (bf16 as uint16 bits) as float32."""
    return (a.view(jnp.bfloat16) if a.dtype == np.uint16 else a).astype(
        np.float32)


def _jax_state(dtype, seed=0):
    st = jfields.initial_state(jax.random.PRNGKey(seed), GRID, ensemble=E,
                               dtype=jnp.dtype(dtype))
    # Nonzero stage tendencies from the first step on.
    noise = jfields.initial_state(jax.random.PRNGKey(seed + 1), GRID,
                                  ensemble=E, dtype=jnp.dtype(dtype))
    return jfields.WeatherState(fields=st.fields, wcon=st.wcon, tens=st.tens,
                                stage_tens=noise.tens)


def _compare(op, dtype, want, got, inp):
    fw, _, _, sw = want
    fg, _, _, sg = got
    for name in fw:
        a, b = _as_f32(fg[name]), np.asarray(fw[name], np.float32)
        s_a, s_b = _as_f32(sg[name]), np.asarray(sw[name], np.float32)
        if dtype == "bfloat16":
            tol = 0.25 if op == "dycore" else 0.15
            np.testing.assert_allclose(a, b, atol=tol, err_msg=name)
            np.testing.assert_allclose(s_a, s_b, atol=tol, err_msg=name)
            continue
        np.testing.assert_allclose(s_a, s_b, atol=TOL[op], err_msg=name)
        err = np.abs(a - b)
        if op == "dycore":
            f2 = inp.fields[name] + jref.DEFAULT_DT * jnp.asarray(s_b)
            fragile = np.asarray(jref.limiter_fragile_mask(f2))
            assert err[~fragile].max(initial=0.0) <= TOL[op], name
            assert err.max() <= LOOSE, name
        else:
            assert err.max() <= TOL[op], name


@pytest.mark.parametrize("op,variant", PLANS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_steps_match_the_reference(op, variant, dtype):
    kw = dict(grid_shape=GRID, ensemble=E, op=op, variant=variant,
              dtype=dtype)
    jplan = jcompile(JProgram(**kw))
    plan = compile(StencilProgram(**kw), device="cpu")
    assert plan.pallas_calls_per_round == jplan.pallas_calls_per_round
    js = _jax_state(dtype)
    for _ in range(STEPS):
        want = jplan.step(js)
        got = plan.step(_to_port(js))
        assert set(got.fields) == set(want.fields)
        jw = ({k: _np(v) for k, v in want.fields.items()}, None, None,
              {k: _np(v) for k, v in want.stage_tens.items()})
        _compare(op, dtype, jw, convert.state_to_numpy(got), js)
        js = want


def test_run_is_repeated_step():
    js = _jax_state("float32")
    plan = compile(StencilProgram(grid_shape=GRID, ensemble=E), device="cpu")
    st = _to_port(js)
    ran = plan.run(st, 2)
    stepped = plan.step(plan.step(st))
    for n in ran.fields:
        assert torch.equal(ran.fields[n], stepped.fields[n])
        assert torch.equal(ran.stage_tens[n], stepped.stage_tens[n])
    assert plan.run(st, 0) is st
    assert plan.round_plan(1) is plan
    with pytest.raises(ValueError):
        plan.run(st, -1)


def test_cpu_plans_launch_no_kernel():
    st = fields.initial_state(torch.Generator().manual_seed(0), GRID, E,
                              device="cpu")
    _build.reset_launches()
    kernelled = [dict(op=op, variant=v) for op, v in PLANS if v != "unfused"]
    kernelled += [dict(op=op, variant="kstep", k_steps=k)
                  for op, k in KSTEP_PLANS]
    for kw in kernelled:
        compile(StencilProgram(grid_shape=GRID, ensemble=E, **kw),
                device="cpu").run(st, 5)
    assert set(_build.LAUNCHES) == {"hdiff", "vadvc", "dycore_fused",
                                    "dycore_kstep", "hdiff_kstep", "hadv",
                                    "copy", "flash_attn", "lru_scan",
                                    "xent", "slot_guard"}
    assert all(n == 0 for n in _build.LAUNCHES.values()), _build.LAUNCHES


def _kstep_plans(op, k, dtype):
    kw = dict(grid_shape=GRID, ensemble=E, op=op, variant="kstep", k_steps=k,
              dtype=dtype)
    return jcompile(JProgram(**kw)), compile(StencilProgram(**kw),
                                             device="cpu")


@pytest.mark.parametrize("op,k", KSTEP_PLANS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kstep_run_matches_the_reference(op, k, dtype):
    """5 steps of a k-step plan, full rounds then a ragged tail, against
    the reference's. dycore: the reference's ragged-tail tolerance
    (`tests/test_program.py`: at most 4 points over 1e-5, none over 0.05,
    since a limiter branch may flip along the chain); hdiff: 1e-5;
    bfloat16: 0.5, the reference's k-step bf16 tolerance."""
    jplan, plan = _kstep_plans(op, k, dtype)
    assert (plan.variant, plan.k_steps) == (jplan.variant, jplan.k_steps)
    js = _jax_state(dtype)
    want = jplan.run(js, 5)
    got = convert.state_to_numpy(plan.run(_to_port(js), 5))
    for name in want.fields:
        for g, w in ((got[0][name], want.fields[name]),
                     (got[3][name], want.stage_tens[name])):
            err = np.abs(_as_f32(g) - np.asarray(w, np.float32))
            if dtype == "bfloat16":
                assert err.max() <= 0.5, name
            elif op == "dycore":
                bad = int((err > 1e-5).sum())
                assert bad <= 4 and err.max() < LOOSE, (name, bad, err.max())
            else:
                assert err.max() <= 1e-5, name


@pytest.mark.parametrize("op,k", KSTEP_PLANS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kstep_run_is_the_whole_state_run(op, k, dtype):
    """The port's own contract: a k-step `run(5)` is bit-equal to the
    whole-state plan's `run(5)` for hdiff (each in-kernel step rounds
    through the storage dtype), and for dycore in float32 (the state stays
    in float32 between steps, which a float32 whole-state step stores
    exactly). A bfloat16 dycore round rounds once where the whole-state
    steps round every step: within 0.5, the reference's k-step bf16
    tolerance."""
    st = _to_port(_jax_state(dtype))
    _, plan = _kstep_plans(op, k, dtype)
    whole = compile(StencilProgram(grid_shape=GRID, ensemble=E, op=op,
                                   dtype=dtype), device="cpu")
    assert whole.variant == "whole_state"
    got, want = plan.run(st, 5), whole.run(st, 5)
    for part in ("fields", "stage_tens"):
        for name in got.fields:
            a, b = getattr(got, part)[name], getattr(want, part)[name]
            if op == "dycore" and dtype == "bfloat16":
                assert (a.float() - b.float()).abs().max() <= 0.5, name
            else:
                assert torch.equal(a, b), (part, name)


@pytest.mark.parametrize("op,k", KSTEP_PLANS)
def test_kstep_report_structural_keys_match(op, k):
    jplan, plan = _kstep_plans(op, k, "float32")
    want, got = jplan.report(), plan.report()
    for key in STRUCTURAL:
        assert got[key] == want[key], key
    assert got["program"] == want["program"]
    for tail in range(1, k):
        jtail, tail_plan = jplan.round_plan(tail), plan.round_plan(tail)
        assert tail_plan.k_steps == tail == jtail.k_steps
        assert tail_plan.variant == jtail.variant
        assert tail_plan.report()["compute_grid"] == \
            jtail.report()["compute_grid"]
        assert plan.round_plan(tail) is tail_plan       # cached


@pytest.mark.parametrize("op", ["dycore", "hdiff"])
def test_kstep_too_deep_for_the_grid_is_refused(op):
    kw = dict(grid_shape=(4, 8, 8), op=op, variant="kstep", k_steps=5)
    with pytest.raises(ValueError):
        jcompile(JProgram(**kw))
    with pytest.raises(ValueError):
        compile(StencilProgram(**kw), device="cpu")


@pytest.mark.parametrize("op", ["dycore", "hdiff"])
def test_kstep_auto_resolves_as_the_reference(op):
    kw = dict(grid_shape=GRID, ensemble=E, op=op, variant="kstep")
    jplan = jcompile(JProgram(**kw))
    plan = compile(StencilProgram(**kw), device="cpu")
    assert (plan.variant, plan.k_steps) == (jplan.variant, jplan.k_steps) \
        == ("whole_state", 1)
    plan = compile(StencilProgram(grid_shape=GRID, op=op, k_steps=3),
                   device="cpu")
    assert (plan.variant, plan.k_steps) == ("kstep", 3)
    assert plan.round_plan(2).k_steps == 2
    assert plan.round_plan(3) is plan
    with pytest.raises(ValueError):
        plan.round_plan(4)


@pytest.mark.parametrize("kw", [
    dict(op="dycore"), dict(op="hdiff", dtype="bfloat16", ensemble=3),
    dict(op="vadvc", variant="per_field", fields=("u", "t")),
    dict(op="dycore", variant="kstep", k_steps=2),
    dict(op="dycore", exchange_dtype="bfloat16", hardware="power9"),
])
def test_program_json_round_trips_across_packages(kw):
    jprog = JProgram(grid_shape=GRID, **kw)
    prog = StencilProgram(grid_shape=GRID, **kw)
    assert json.dumps(prog.to_json()) == json.dumps(jprog.to_json())
    assert StencilProgram.from_json(
        json.loads(json.dumps(jprog.to_json()))) == prog
    assert JProgram.from_json(
        json.loads(json.dumps(prog.to_json()))) == jprog


@pytest.mark.parametrize("kw", [
    dict(grid_shape=(4, 16)), dict(ensemble=0), dict(fields=()),
    dict(boundary="open"), dict(halo=3), dict(variant="fancy"),
    dict(k_steps=0), dict(op="vadvc", k_steps=2),
    dict(variant="whole_state", k_steps=2), dict(variant="kstep", k_steps=1),
    dict(op="nope"), dict(hardware="nope"),
])
def test_program_checks_match_the_reference(kw):
    kw = {"grid_shape": GRID, **kw}
    with pytest.raises(ValueError):
        JProgram(**kw)
    with pytest.raises(ValueError):
        StencilProgram(**kw)


def _structure(jplan):
    """The structural keys and program of a reference plan, read off the
    plan itself (the reference's `report()` raises for `asselin`)."""
    prog = jplan.program
    return {"op": prog.op, "variant": jplan.variant,
            "k_steps": jplan.k_steps, "local_grid": list(jplan.local_grid),
            "compute_grid": list(jplan.compute_grid),
            "pallas_calls_per_round": jplan.pallas_calls_per_round,
            "collectives_per_round": jplan.collectives_per_round,
            "footprint": jplan.op_def.describe(prog.n_fields, jplan.k_steps),
            "program": prog.to_json(), "tile": jplan.tile_plan}


@pytest.mark.parametrize("op,variant", PLANS)
def test_report_structural_keys_match(op, variant):
    kw = dict(grid_shape=GRID, ensemble=E, op=op, variant=variant)
    jplan = jcompile(JProgram(**kw))
    if op == "asselin":
        # no tile: the reference's report() takes `.tile` of None
        with pytest.raises(AttributeError):
            jplan.report()
        want = _structure(jplan)
    else:
        want = jplan.report()
    got = compile(StencilProgram(**kw), device="cpu").report()
    for key in STRUCTURAL:
        assert got[key] == want[key], key
    assert got["program"] == want["program"]
    assert (got["tile"] is None) == (want["tile"] is None)
    if got["tile"] is not None:
        assert got["tile"]["ty"] >= 1
    json.dumps(got)


@pytest.mark.parametrize("call", [
    lambda p: ForecastEngine(slots=1, device="cpu", mesh=make_mesh(
        (1, 1), ("data", "model"), devices=["cpu"])),
])
def test_unported_options_raise(call):
    """No option of the JAX package is refused any more: meshes run plans
    (`tests/test_torch_mesh.py`) and the forecast engine
    (`tests/test_torch_forecast_mesh.py`). A mesh that is not a
    `launch.mesh.Mesh` raises in both."""
    eng = call(StencilProgram(grid_shape=GRID))
    assert eng.stats()["mesh_devices"] == [0]
    with pytest.raises(TypeError, match="Mesh"):
        compile(StencilProgram(grid_shape=GRID), mesh=object(),
                device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        ForecastEngine(slots=1, mesh=object())


@pytest.mark.parametrize("variant", ["whole_state", "unfused"])
def test_asselin_plan_reports(variant):
    """The solo asselin plan has no kernel tile and no model window: its
    report models the traffic at a window of the whole grid (`ny` rows)
    and has no model, where the reference's report raises."""
    plan = compile(StencilProgram(grid_shape=GRID, ensemble=E, op="asselin",
                                  variant=variant), device="cpu")
    rep = plan.report()
    json.dumps(rep)
    assert rep["tile"] is None and rep["model"] is None
    assert rep["traffic_model_ty"] == GRID[1]
    assert rep["pallas_calls_per_round"] == 0
    assert rep["traffic"]["stream_per_round"] == rep["traffic"]["ideal"] > 0


def test_plan_refuses_a_state_on_another_device_or_shape():
    plan = compile(StencilProgram(grid_shape=GRID, ensemble=E), device="cpu")
    st = fields.zeros_state(GRID, E, device="meta")
    with pytest.raises(ValueError, match="compiled for cpu"):
        plan.step(st)
    with pytest.raises(ValueError, match="ensemble"):
        plan.step(fields.zeros_state(GRID, E + 1, device="cpu"))
    with pytest.raises(ValueError, match="dtype"):
        plan.step(fields.zeros_state(GRID, E, dtype="bfloat16",
                                     device="cpu"))


def test_compile_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile(StencilProgram(grid_shape=GRID))


def test_initial_state_recipe():
    st = fields.initial_state(torch.Generator().manual_seed(3), GRID, E,
                              dtype="bfloat16", device="cpu")
    again = fields.initial_state(torch.Generator().manual_seed(3), GRID, E,
                                 dtype=torch.bfloat16, device="cpu")
    assert set(st.fields) == set(fields.PROGNOSTIC)
    assert st.grid_shape == GRID and st.dtype == torch.bfloat16
    for n in fields.PROGNOSTIC:
        assert st.fields[n].shape == (E,) + GRID
        assert torch.equal(st.fields[n], again.fields[n])
        assert not torch.any(st.stage_tens[n])
        assert st.tens[n].float().abs().max() < st.fields[n].float().abs(
        ).max()
    assert 0 < float(st.wcon.float().abs().max()) < 1.0


def test_state_conversion_keeps_bf16_bits():
    js = _jax_state("bfloat16")
    back = convert.state_to_numpy(_to_port(js))
    for name, arr in js.fields.items():
        assert back[0][name].dtype == np.uint16
        np.testing.assert_array_equal(back[0][name], _np(arr).view(np.uint16))
    np.testing.assert_array_equal(back[1], _np(js.wcon).view(np.uint16))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["dycore", "hdiff", "vadvc"])
@pytest.mark.parametrize("variant", ["whole_state", "per_field"])
def test_cuda_plan_matches_cpu_plan(op, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    st = fields.initial_state(torch.Generator().manual_seed(0), GRID, E,
                              device="cpu")
    prog = StencilProgram(grid_shape=GRID, ensemble=E, op=op,
                          variant=variant)
    on_card = fields.WeatherState(
        fields=fields.field_views(dycore.stack_state(st.fields).cuda(),
                                  fields.PROGNOSTIC),
        wcon=st.wcon.cuda(),
        tens={k: v.cuda() for k, v in st.tens.items()},
        stage_tens={k: v.cuda() for k, v in st.stage_tens.items()})
    plan = compile(prog, device="cuda")
    _build.reset_launches()
    got = plan.run(on_card, 2)
    kernel = {"dycore": "dycore_fused"}.get(op, op)
    assert _build.LAUNCHES[kernel] == 2 * plan.pallas_calls_per_round
    assert sum(_build.LAUNCHES.values()) == _build.LAUNCHES[kernel]
    want = compile(prog, device="cpu").run(st, 2)
    for n in want.fields:
        assert (got.fields[n].cpu() - want.fields[n]).abs().max() <= LOOSE
        assert (got.stage_tens[n].cpu() - want.stage_tens[n]).abs().max() \
            <= 2e-4


@pytest.mark.parametrize("variant", ["whole_state", "unfused"])
def test_hadv_plan_leaves_one_contiguous_stack(variant):
    """A hadv_upwind step writes a new contiguous field-stacked state, so
    the next step's `stack_state` is a view of it, and the lowering holds
    no `torch.cat` and no crop: the wrap is read inside the step."""
    import inspect

    from repro_torch.weather import stencil_ops

    st = fields.initial_state(torch.Generator().manual_seed(0), GRID, E,
                              device="cpu")
    plan = compile(StencilProgram(grid_shape=GRID, ensemble=E,
                                  op="hadv_upwind", variant=variant),
                   device="cpu")
    nxt = plan.step(st)
    stacked = dycore.stack_state(nxt.fields)
    assert stacked.is_contiguous() and stacked.shape == (E, 4) + GRID
    assert stacked.data_ptr() == nxt.fields["u"].data_ptr()
    assert stacked.data_ptr() != dycore.stack_state(st.fields).data_ptr()
    for fn in (stencil_ops._hadv_local_step, stencil_ops._vadvc_local_step):
        assert "torch.cat" not in inspect.getsource(fn)


@pytest.mark.cuda
@pytest.mark.parametrize("op,kernel", [("hadv_upwind", "hadv"),
                                       ("vadvc", "vadvc")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_op_step_is_one_launch(op, kernel, dtype):
    """One whole-state step of `op="hadv_upwind"` launches one hadv kernel
    and of `op="vadvc"` one vadvc kernel, and no other kernel; each equal
    to the CPU plan's step (fp32 bits for hadv, vadvc within 2e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    st = fields.initial_state(torch.Generator().manual_seed(0), GRID, E,
                              dtype=dtype, device="cpu")
    st.stage_tens = fields.initial_state(torch.Generator().manual_seed(1),
                                         GRID, E, dtype=dtype,
                                         device="cpu").tens
    on_card = fields.WeatherState(
        fields=fields.field_views(dycore.stack_state(st.fields).cuda(),
                                  fields.PROGNOSTIC),
        wcon=st.wcon.cuda(),
        tens={k: v.cuda() for k, v in st.tens.items()},
        stage_tens={k: v.cuda() for k, v in st.stage_tens.items()})
    prog = StencilProgram(grid_shape=GRID, ensemble=E, op=op, dtype=dtype)
    plan = compile(prog, device="cuda")
    _build.reset_launches()
    got = plan.step(on_card)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == 1 == sum(_build.LAUNCHES.values())
    want = compile(prog, device="cpu").step(st)
    for n in want.fields:
        for part in ("fields", "stage_tens"):
            a = getattr(got, part)[n].cpu().float()
            b = getattr(want, part)[n].float()
            if op == "hadv_upwind" and dtype == "float32":
                assert torch.equal(a, b), (part, n)
            else:
                tol = 2e-4 if dtype == "float32" else 2e-2
                assert (a - b).abs().max() <= tol + 2.0 ** -7 * b.abs().max()


def test_stack_state_takes_stacked_states_without_a_copy():
    st = fields.initial_state(torch.Generator().manual_seed(0), GRID, E,
                              device="cpu")
    plan = compile(StencilProgram(grid_shape=GRID, ensemble=E), device="cpu")
    nxt = plan.step(st)
    for d in (st.fields, st.tens, st.stage_tens, nxt.stage_tens,
              dycore.unstack_state(torch.randn((E, 4) + GRID)),
              _to_port(_jax_state("float32")).fields):
        stacked = dycore.stack_state(d)
        assert stacked.is_contiguous()
        assert stacked.data_ptr() == d["u"].data_ptr()
        assert torch.equal(stacked, torch.stack(list(d.values()), dim=1))


@pytest.mark.parametrize("names", [("v", "u", "t", "pp"), ("u", "t")])
def test_stack_state_copies_what_is_not_one_stack(names):
    st = fields.initial_state(torch.Generator().manual_seed(0), GRID, E,
                              device="cpu")
    stacked = dycore.stack_state(st.fields, names)
    if names == ("u", "t"):          # a subset: not consecutive planes
        assert stacked.data_ptr() != st.fields["u"].data_ptr()
    assert torch.equal(stacked,
                       torch.stack([st.fields[n] for n in names], dim=1))
    apart = {n: st.fields[n].clone() for n in fields.PROGNOSTIC}
    assert torch.equal(dycore.stack_state(apart),
                       dycore.stack_state(st.fields))
