"""The program's host spans (`core/spans.py`): off unless a profiler records,
nested as a plan runs them, and the op lowering's copy counter `LOWERING`
against the shapes the lowering writes."""

import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import spans
from repro_torch.kernels.dycore_fused.ref import pad_periodic
from repro_torch.kernels.hdiff import ref as hdiff_ref
from repro_torch.weather import dycore
from repro_torch.weather.fields import WeatherState, field_views
from repro_torch.weather.program import StencilProgram, compile

GRID, E = (3, 8, 10), 2
HALO = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _state(program, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(7)
    shape = (program.ensemble, program.n_fields) + program.grid_shape
    draw = lambda s: torch.randn(s, generator=gen, device=device)
    group = lambda: field_views(draw(shape), program.fields)
    return WeatherState(fields=group(),
                        wcon=draw((program.ensemble,) + program.grid_shape),
                        tens=group(), stage_tens=group())


def _plan(op, device="cpu", grid=GRID, ensemble=E):
    program = StencilProgram(grid_shape=grid, ensemble=ensemble, op=op)
    plan = compile(program, device=device)
    assert plan.variant == "whole_state" and plan.k_steps == 1
    return program, plan


def _recorded(fn, device="cpu"):
    """`fn()` under the profiler; the program's spans, `(start, end, name)`
    in start order."""
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device != "cpu" else [])
    with profile(activities=acts) as prof:
        fn()
        if device != "cpu":
            torch.cuda.synchronize()
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("nero.")
                  and e.device_type() == torch.autograd.DeviceType.CPU)


def _inside(outer, spans_):
    return [s for s in spans_ if outer[0] <= s[0] and s[1] <= outer[1]
            and s != outer]


def test_no_profiler_enters_no_range(monkeypatch):
    entered = []
    monkeypatch.setattr(spans, "_range", lambda name: entered.append(name))
    program, plan = _plan("hdiff")
    plan.run(_state(program), 2)
    assert spans.span("nero.x") is spans.span("nero.y")
    with spans.span("nero.x"):
        pass
    assert spans.spanned("nero.f")(lambda a: a + 1)(1) == 2
    assert entered == []


def test_spans_record_under_the_profiler():
    program, plan = _plan("hdiff")
    state = _state(program)
    got = _recorded(lambda: plan.run(state, 3))
    runs = [s for s in got if s[2] == "nero.plan.run"]
    assert len(runs) == 1
    rounds = [s for s in _inside(runs[0], got) if s[2] == "nero.plan.round"]
    assert len(rounds) == 3
    for r in rounds:
        assert [s[2] for s in _inside(r, got)] == ["nero.lower.stack",
                                                    "nero.lower.pad"]
    assert {s[2] for s in got} == {"nero.plan.run", "nero.plan.round",
                                   "nero.lower.stack", "nero.lower.pad"}
    # a single step is a round too
    got = _recorded(lambda: plan.step(state))
    assert [s[2] for s in got] == ["nero.plan.round", "nero.lower.stack",
                                   "nero.lower.pad"]


def test_lowering_counts_the_hdiff_copies():
    """On the CPU the whole-state round runs the plain step on the padded
    stack: the stack is a view on the first round (the state is
    field-stacked) and a copy from the second (the crop is not); the wrap
    pad's two cats copy every round."""
    program, plan = _plan("hdiff")
    nz, ny, nx = GRID
    planes = E * program.n_fields * nz
    stack = planes * ny * nx * 4
    pad = planes * (ny + 2 * HALO) * nx * 4 + \
        planes * (ny + 2 * HALO) * (nx + 2 * HALO) * 4
    spans.reset_lowering()
    plan.run(_state(program), 3)
    assert spans.LOWERING == {"rounds": 3, "steps": 3, "copies": 2 + 3 * 2,
                              "bytes": 2 * stack + 3 * pad}
    spans.reset_lowering()
    assert spans.LOWERING == {"rounds": 0, "steps": 0, "copies": 0,
                              "bytes": 0}


def test_lowering_counts_the_steps_of_k_step_rounds():
    """Two rounds of k = 2 and a tail round of 1: three rounds, five
    steps; on the CPU each round's pad is as deep as its reach, 2·k."""
    nz, ny, nx = GRID
    program = StencilProgram(grid_shape=GRID, ensemble=E, op="hdiff",
                             k_steps=2)
    plan = compile(program, device="cpu")
    assert plan.k_steps == 2
    planes = E * program.n_fields * nz
    pad = lambda h: planes * (ny + 2 * h) * (2 * nx + 2 * h) * 4
    spans.reset_lowering()
    plan.run(_state(program), 5)
    assert spans.LOWERING["rounds"] == 3 and spans.LOWERING["steps"] == 5
    assert spans.LOWERING["bytes"] == 2 * planes * ny * nx * 4 + \
        2 * pad(2 * HALO) + pad(HALO)


def _padded_rounds(program, state, n):
    """`n` hdiff rounds as the lowering ran them before it read the wrap in
    the step: wrap-pad by 2, the plain passthrough step, the interior
    crop; the field-stacked result."""
    f = dycore.stack_state(state.fields, program.fields)
    ny, nx = f.shape[-2:]
    for _ in range(n):
        f = hdiff_ref.hdiff(pad_periodic(f, HALO), coeff=program.coeff)[
            ..., HALO:HALO + ny, HALO:HALO + nx]
    return f


@pytest.mark.parametrize("grid,ensemble", [(GRID, E), ((2, 5, 7), 1),
                                           ((4, 3, 2), 3)])
def test_whole_state_hdiff_run_equals_padded_rounds(grid, ensemble):
    program, plan = _plan("hdiff", grid=grid, ensemble=ensemble)
    state = _state(program)
    got = plan.run(state, 3)
    assert torch.equal(dycore.stack_state(got.fields, program.fields),
                       _padded_rounds(program, state, 3))


@pytest.mark.parametrize("variant", ["whole_state", "unfused"])
def test_cpu_hdiff_round_pads_and_crops(variant):
    """On the CPU (no kernel reads the wrap) the whole-state round is the
    oracle's: the plain step on the wrap-padded stack, bit for bit, and
    fields that are crops of the padded output, which the next round
    stacks with a copy."""
    program = StencilProgram(grid_shape=GRID, ensemble=E, op="hdiff",
                             variant=variant)
    plan = compile(program, device="cpu")
    state = _state(program)
    out = plan.step(state)
    assert torch.equal(dycore.stack_state(out.fields, program.fields),
                       _padded_rounds(program, state, 1))
    assert not out.fields["u"].is_contiguous()
    spans.reset_lowering()
    plan.step(out)
    assert spans.LOWERING["copies"] == 1 + 2


@pytest.mark.cuda
def test_hdiff_round_writes_one_contiguous_stack(cuda):
    """After a whole-state round on the card the fields are the planes of
    one new contiguous `(e, nf, nz, ny, nx)` stack, which the next round
    stacks as a view."""
    program, plan = _plan("hdiff", device="cuda")
    state = _state(program, device="cuda")
    out = plan.step(state)
    base = dycore._stacked_base([out.fields[n] for n in program.fields])
    assert base is not None and base.is_contiguous()
    assert base.shape == (E, program.n_fields) + GRID
    assert base.data_ptr() != state.fields["u"].data_ptr()
    spans.reset_lowering()
    plan.step(out)
    assert spans.LOWERING["copies"] == 0 and spans.LOWERING["bytes"] == 0


def test_lowering_counts_no_vadvc_copy():
    program, plan = _plan("vadvc")
    spans.reset_lowering()
    plan.run(_state(program), 3)
    plan.step(_state(program))
    assert spans.LOWERING == {"rounds": 4, "steps": 4, "copies": 0,
                              "bytes": 0}


def test_contiguous_counts_only_a_copy():
    t = torch.zeros(4, 6)
    spans.reset_lowering()
    assert spans.contiguous(t) is t
    assert spans.LOWERING["copies"] == 0
    out = spans.contiguous(t.t())
    assert out.is_contiguous() and torch.equal(out, t.t())
    assert spans.LOWERING == {"rounds": 0, "steps": 0, "copies": 1,
                              "bytes": 96}


@pytest.mark.cuda
def test_hdiff_spans_and_counter_on_the_card(cuda):
    """The whole-state hdiff round on the card: one periodic launch in its
    span inside the round, a stack that is a view, no pad and no copy; the
    result bit for bit the padded rounds' on the card."""
    grid = (8, 37, 70)
    program, plan = _plan("hdiff", device="cuda", grid=grid)
    state = _state(program, device="cuda")
    plan.run(state, 1)
    torch.cuda.synchronize()
    spans.reset_lowering()
    got = _recorded(lambda: plan.run(state, 3), device="cuda")
    assert spans.LOWERING == {"rounds": 3, "steps": 3, "copies": 0,
                              "bytes": 0}
    rounds = [s for s in got if s[2] == "nero.plan.round"]
    assert len(rounds) == 3
    for r in rounds:
        assert [s[2] for s in _inside(r, got)] == ["nero.lower.stack",
                                                    "nero.kernel.hdiff"]
    from repro_torch.kernels.hdiff.hdiff import hdiff_cuda
    f = dycore.stack_state(state.fields, program.fields)
    ny, nx = grid[1:]
    for _ in range(3):
        planes = pad_periodic(f, HALO).reshape(-1, ny + 4, nx + 4)
        f = hdiff_cuda(planes).reshape(f.shape[:-2] + (ny + 4, nx + 4))[
            ..., HALO:HALO + ny, HALO:HALO + nx]
    out = plan.run(state, 3)
    assert torch.equal(dycore.stack_state(out.fields, program.fields), f)


@pytest.mark.cuda
def test_dycore_spans_and_counter_on_the_card(cuda):
    """The whole-state dycore round on the card: the staggered velocity's
    roll and sum (two copies of wcon a round) and one kernel launch, each
    in its span inside the round."""
    grid = (8, 32, 32)
    program, plan = _plan("dycore", device="cuda", grid=grid)
    state = _state(program, device="cuda")
    plan.run(state, 1)
    torch.cuda.synchronize()
    spans.reset_lowering()
    got = _recorded(lambda: plan.run(state, 3), device="cuda")
    wcon = E * grid[0] * grid[1] * grid[2] * 4
    assert spans.LOWERING == {"rounds": 3, "steps": 3, "copies": 6,
                              "bytes": 6 * wcon}
    rounds = [s for s in got if s[2] == "nero.plan.round"]
    assert len(rounds) == 3
    for r in rounds:
        names = [s[2] for s in _inside(r, got)]
        assert names.count("nero.lower.staggered_w") == 1
        assert names.count("nero.kernel.dycore_fused") == 1
