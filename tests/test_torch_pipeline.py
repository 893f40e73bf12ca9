"""The port's pipeline programs against the JAX package's, and their own
bit contracts.

`repro_torch.weather.pipeline.PipelineProgram` chains registered stages
into one plan on one device. Checked on the CPU, where each stage takes its
kernel's plain version (the JAX plans run their Pallas kernels in interpret
mode, as the JAX package's own tests run them):

* the flagship chain `hadv_upwind -> vadvc_update -> hdiff` (a step, the
  k=2 round, `run(state, 3)` on the k=2 plan) against the JAX package's
  plan: float32 within 2e-4 (vadvc's tolerance, the loosest stage) off the
  points where an hdiff stage's flux limiter may flip and within 0.05
  everywhere; bfloat16 within 0.25;
* inside the port, bit for bit: every chain of 1-3 distinct chainable
  stages (85) equals its stages run as solo plans one after the other,
  and on a (2, 2) mesh of CPU shards its mesh round (one packed exchange a
  round) equals its stages' solo mesh plans one after the other; a
  subset binding leaves the unbound fields as the earlier stages left
  them; the k=2 round equals two rounds; the asselin chain rides nothing
  and launches nothing;
* for the same 85 chains, the registered chain op's rides at k = 1 and 2,
  variants and halo equal the JAX package's; the flagship's footprint,
  compute grid, launches a round and modelled traffic too;
* programs round-trip as JSON across the packages, `report()["program"]`
  too, with a cache key apart from the solo programs'; bad programs are
  refused with the JAX package's messages.

The `cuda`-marked cases need the card: the chain there against the chain
on the CPU, against the solo plans bit for bit, and its launches.
"""

import functools
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.kernels.dycore_fused import ref as jref
from repro.weather import fields as jfields
from repro.weather.pipeline import PipelineProgram as JPipe
from repro.weather.pipeline import PipelineStage as JStage
from repro.weather.program import StencilProgram as JProgram
from repro.weather.program import compile as jcompile
from repro.weather.stencil_ops import get_stencil_op as jget_stencil_op
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_mesh
from repro_torch.weather import convert, domain, dycore, fields
from repro_torch.weather.pipeline import (PipelineProgram, PipelineStage,
                                          pipeline_op_name)
from repro_torch.weather.program import (StencilProgram, compile,
                                         plan_cache_key)
from repro_torch.weather.stencil_ops import get_stencil_op

GRID, E = (3, 8, 8), 2
COEFF = 0.05
FLAGSHIP = ("hadv_upwind", "vadvc_update", "hdiff")
# every chainable op (the JAX package's ops with an apply_stage lowering)
CHAINABLE = ("hadv_upwind", "vadvc_update", "hdiff", "vadvc", "asselin")
CHAINS = [c for n in (1, 2, 3) for c in itertools.permutations(CHAINABLE, n)]
BINDING = (("hadv_upwind", None), ("hdiff", ("u", "v")))
FP32_TOL = 2e-4       # vadvc's, the loosest stage's
LOOSE = 0.05          # |coeff * flux| scale at a flipped limiter branch
BF16_TOL = 0.25


def _pipe(stages, cls=PipelineProgram, stage_cls=PipelineStage, **kw):
    """A chain program at the test grid; `stages` are op names or (op,
    binding) pairs."""
    kw = {"variant": "whole_state", "k_steps": 1, **kw}
    stages = tuple(s if isinstance(s, str) else stage_cls(op=s[0],
                                                          fields=s[1])
                   for s in stages)
    return cls(grid_shape=GRID, ensemble=E, coeff=COEFF, stages=stages, **kw)


def _jax_state(dtype, seed=0):
    st = jfields.initial_state(jax.random.PRNGKey(seed), GRID, ensemble=E,
                               dtype=jnp.dtype(dtype))
    # nonzero stage tendencies from the first stage on
    noise = jfields.initial_state(jax.random.PRNGKey(seed + 1), GRID,
                                  ensemble=E, dtype=jnp.dtype(dtype))
    return jfields.WeatherState(fields=st.fields, wcon=st.wcon, tens=st.tens,
                                stage_tens=noise.tens)


def _to_port(js, device="cpu"):
    d = lambda m: {k: np.asarray(v) for k, v in m.items()}
    return convert.state_from_numpy(d(js.fields), np.asarray(js.wcon),
                                    d(js.tens), d(js.stage_tens),
                                    device=device)


def _port_state(seed=0, dtype="float32"):
    """A state made by the port alone, with nonzero stage tendencies."""
    gen = torch.Generator().manual_seed(seed)
    st = fields.initial_state(gen, GRID, E, dtype=dtype, device="cpu")
    st.stage_tens = fields.initial_state(gen, GRID, E, dtype=dtype,
                                         device="cpu").tens
    return st


def _to_device(st, device):
    move = lambda d: fields.field_views(
        dycore.stack_state(d).to(device), fields.PROGNOSTIC)
    return fields.WeatherState(fields=move(st.fields),
                               wcon=st.wcon.to(device), tens=move(st.tens),
                               stage_tens=move(st.stage_tens))


def _f32(a):
    """A numpy array from either package (bf16 as `uint16` bits from the
    port, as `bfloat16` from JAX) as float32."""
    a = np.asarray(a)
    return (a.view(jnp.bfloat16) if a.dtype == np.uint16 else a).astype(
        np.float32)


def _solo(stages, st, device="cpu", dtype="float32"):
    """The chain's stages as solo whole-state plans, one after the
    other."""
    for op in stages:
        st = compile(StencilProgram(grid_shape=GRID, ensemble=E, coeff=COEFF,
                                    op=op, dtype=dtype),
                     device=device).step(st)
    return st


def _assert_equal(a, b):
    for part in ("fields", "stage_tens"):
        for n in fields.PROGNOSTIC:
            assert torch.equal(getattr(a, part)[n], getattr(b, part)[n]), \
                (part, n)


def _spread(mask):
    """A (e, nz, ny, nx) mask one chain step on: the whole column of each
    point (the Thomas solve couples the levels) and 3 points around it in
    y and x (hadv's reach and hdiff's), periodic."""
    col = np.broadcast_to(mask.any(axis=-3, keepdims=True), mask.shape)
    out = col.copy()
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            out |= np.roll(np.roll(col, dy, axis=-2), dx, axis=-1)
    return out


def _fragile(st, steps):
    """Per field, the points of the chain's output that a flipped hdiff
    limiter branch in one of `steps` steps may have moved: each step's
    fragile points of its hdiff stage's input (`jref.limiter_fragile_mask`,
    from the port's own solo plans), spread over the steps after it."""
    masks = {n: np.zeros((E,) + GRID, bool) for n in fields.PROGNOSTIC}
    for _ in range(steps):
        st = _solo(FLAGSHIP[:2], st)
        for n in masks:
            f2 = jnp.asarray(st.fields[n].numpy())
            masks[n] = _spread(masks[n]) | np.asarray(
                jref.limiter_fragile_mask(f2))
        st = _solo(FLAGSHIP[2:], st)
    return masks


@functools.lru_cache(maxsize=None)
def _reference_run(dtype, k, steps):
    """The JAX package's flagship plan at k steps a round, `steps` steps
    from `_jax_state(dtype)`: (input, output, its pallas calls a round)."""
    js = _jax_state(dtype)
    jplan = jcompile(_pipe(FLAGSHIP, cls=JPipe, stage_cls=JStage,
                           dtype=dtype, variant="kstep" if k > 1
                           else "whole_state", k_steps=k))
    out = jplan.step(js) if steps == k else jplan.run(js, steps)
    return js, out, jplan.pallas_calls_per_round


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,steps", [(1, 1), (2, 2), (2, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_matches_the_reference(dtype, k, steps):
    """One step, one k=2 round and `run(state, 3)` of the k=2 plan."""
    js, want, calls = _reference_run(dtype, k, steps)
    plan = compile(_pipe(FLAGSHIP, dtype=dtype, variant="kstep" if k > 1
                         else "whole_state", k_steps=k), device="cpu")
    assert plan.k_steps == k and plan.pallas_calls_per_round == calls
    st = _to_port(js)
    got = plan.step(st) if steps == k else plan.run(st, steps)
    fragile = _fragile(st, steps) if dtype == "float32" else None
    for part in ("fields", "stage_tens"):
        for n in fields.PROGNOSTIC:
            a = _f32(convert.tensor_to_numpy(getattr(got, part)[n]))
            b = _f32(getattr(want, part)[n])
            err = np.abs(a - b)
            if dtype == "bfloat16":
                assert err.max() <= BF16_TOL, (part, n, err.max())
                continue
            assert err[~fragile[n]].max(initial=0.0) <= FP32_TOL, (part, n)
            assert err.max() <= LOOSE, (part, n, err.max())


def _chain_id(chain):
    return "->".join(c if isinstance(c, str) else
                     c[0] + ("" if c[1] is None else "[" + ",".join(c[1])
                             + "]") for c in chain)


@pytest.mark.parametrize("chain", CHAINS + [BINDING], ids=_chain_id)
def test_chain_rides_match_the_reference(chain):
    """The backward validity analysis: the chain op's rides at k = 1 and
    2, variants and halo, as the JAX package registers them."""
    mine = get_stencil_op(_pipe(chain).op)
    want = jget_stencil_op(_pipe(chain, cls=JPipe, stage_cls=JStage).op)
    assert mine.name == want.name
    for k in (1, 2):
        assert mine.resolved_rides(k) == want.resolved_rides(k), k
    assert mine.variants == want.variants
    assert mine.halo == want.halo
    assert (mine.reads, mine.writes) == (want.reads, want.writes)
    assert mine.flops_per_point == want.flops_per_point


def test_flagship_report_matches_the_reference(monkeypatch):
    """Footprint, compute grid and launches a round at the test grid; the
    modelled traffic at (8, 128, 128), where the model's chain beats the
    sequence, under the JAX package's spec in both packages."""
    monkeypatch.setenv("REPRO_HWSPEC", "tpu_v5e")
    got = compile(_pipe(FLAGSHIP), device="cpu").report()
    want = jcompile(_pipe(FLAGSHIP, cls=JPipe, stage_cls=JStage)).report()
    for key in ("footprint", "compute_grid", "local_grid",
                "pallas_calls_per_round", "collectives_per_round",
                "program", "traffic_model_ty"):
        assert got[key] == want[key], key
    assert got["compute_grid"] == [3, 14, 14]
    assert got["pallas_calls_per_round"] == 3 and got["tile"] is None
    fp = {r["operand"]: (tuple(r["depth_y"]), tuple(r["depth_x"]))
          for r in got["footprint"]["rides"]}
    assert fp == {"fields": ((3, 2), (3, 2)), "tens": ((2, 2), (2, 2)),
                  "stage_tens": ((2, 2), (2, 2)),
                  "wcon": ((2, 2), (2, 3))}

    kw = dict(grid_shape=(8, 128, 128), ensemble=E, coeff=COEFF,
              stages=FLAGSHIP)
    got = compile(PipelineProgram(**kw), device="cpu").report()
    want = jcompile(JPipe(**kw)).report()
    assert got["traffic_model_ty"] == want["traffic_model_ty"]
    t, t_want = dict(got["traffic"]), dict(want["traffic"])
    assert t.pop("sequential_by_stage") == t_want.pop("sequential_by_stage")
    assert t == pytest.approx(t_want, rel=1e-12)
    t = got["traffic"]
    assert t["chained_reduction_x"] > 1
    assert set(t["sequential_by_stage"]) == set(FLAGSHIP)
    assert sum(t["sequential_by_stage"].values()) == \
        t["sequential_per_round"]
    for key in ("time_us", "gflops", "gflops_per_watt"):
        assert got["model"][key] == pytest.approx(want["model"][key],
                                                  rel=1e-12), key
    for key in ("bottleneck", "hardware", "kernel_class"):
        assert got["model"][key] == want["model"][key], key
    json.dumps(got)


@pytest.mark.parametrize("chain", [FLAGSHIP, BINDING, ("asselin",)],
                         ids=_chain_id)
def test_program_json_round_trips_across_packages(chain):
    prog = _pipe(chain)
    jprog = _pipe(chain, cls=JPipe, stage_cls=JStage)
    assert json.dumps(prog.to_json()) == json.dumps(jprog.to_json())
    back = StencilProgram.from_json(json.loads(json.dumps(jprog.to_json())))
    assert isinstance(back, PipelineProgram) and back == prog
    assert JProgram.from_json(json.loads(json.dumps(prog.to_json()))) \
        == jprog
    rep = compile(prog, device="cpu").report()["program"]
    assert StencilProgram.from_json(rep) == prog
    assert JProgram.from_json(rep) == jprog
    keys = {plan_cache_key(prog)}
    for st in prog.stages:
        keys.add(plan_cache_key(StencilProgram(
            grid_shape=GRID, ensemble=E, coeff=COEFF, op=st.op)))
    assert len(keys) == 1 + len(prog.stages)
    assert hash(prog) == hash(back)


def _refusals(cls, stage_cls):
    return [
        lambda: cls(grid_shape=GRID, stages=()),
        lambda: cls(grid_shape=GRID, stages=("no_such_op",)),
        lambda: cls(grid_shape=GRID, stages=("dycore",)),
        lambda: cls(grid_shape=GRID, stages=(
            stage_cls(op="hdiff", fields=("bogus",)),)),
        lambda: cls(grid_shape=GRID, stages=(
            stage_cls(op="hdiff", fields=()),)),
        lambda: cls(grid_shape=GRID, op="hdiff", stages=("hdiff",)),
        lambda: cls(grid_shape=GRID, stages=(42,)),
        lambda: cls(grid_shape=GRID, halo=1, stages=FLAGSHIP),
        lambda: cls(grid_shape=GRID, k_steps=2, stages=("vadvc",)),
    ]


@pytest.mark.parametrize("case", range(len(_refusals(JPipe, JStage))))
def test_bad_programs_are_refused_as_the_reference(case):
    with pytest.raises(Exception) as want:
        _refusals(JPipe, JStage)[case]()
    with pytest.raises(want.type) as got:
        _refusals(PipelineProgram, PipelineStage)[case]()
    # an unknown op's message lists each package's own registry
    head = lambda e: str(e.value).split("; registered")[0]
    assert head(got) == head(want)


# ---------------------------------------------------------------------------
# Inside the port, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chain", CHAINS, ids=_chain_id)
def test_chain_is_its_solo_sequence(chain):
    """Every chain of 1-3 distinct chainable stages equals its stages run
    as solo plans, bit for bit."""
    st = _port_state(seed=CHAINS.index(chain))
    plan = compile(_pipe(chain), device="cpu")
    _assert_equal(plan.step(st), _solo(chain, st))


@pytest.mark.parametrize("chain", CHAINS + [BINDING], ids=_chain_id)
def test_chain_mesh_round_is_its_solo_mesh_plans(chain):
    """On a (2, 2) mesh every chain's round (one packed exchange for the
    whole chain, the stages on each shard's padded slabs, one crop) equals
    its stages' own mesh plans one after the other, bit for bit, fields and
    stage tendencies; the rides it made are its report's, one a sharded
    direction and side any operand rides."""
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    st = _port_state(seed=len(chain))
    plan = compile(_pipe(chain), mesh=mesh)
    domain.reset_rides()
    out = domain.gather_state(plan.step(st))
    assert domain.RIDES["rides"] == plan.collectives_per_round <= 4
    seq = st
    for stage in chain:
        op, bound = (stage, None) if isinstance(stage, str) else stage
        seq = compile(StencilProgram(
            grid_shape=GRID, ensemble=E, coeff=COEFF, op=op, k_steps=1,
            fields=bound or fields.PROGNOSTIC), mesh=mesh).step(seq)
    _assert_equal(out, domain.gather_state(seq))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_is_its_solo_sequence(dtype):
    st = _port_state(seed=7, dtype=dtype)
    plan = compile(_pipe(FLAGSHIP, dtype=dtype), device="cpu")
    out = plan.step(st)
    _assert_equal(out, _solo(FLAGSHIP, st, dtype=dtype))
    # the round writes new tensors; the input is untouched
    for part in ("fields", "stage_tens"):
        base = lambda s: getattr(s, part)["u"].untyped_storage().data_ptr()
        assert base(out) != base(st)
    _assert_equal(st, _port_state(seed=7, dtype=dtype))


def test_subset_binding_leaves_unbound_fields():
    """hadv_upwind -> hdiff[u,v]: u and v as both solo steps leave them,
    t and pp as the solo hadv leaves them, stage tendencies untouched."""
    st = _port_state(seed=3)
    out = compile(_pipe(BINDING), device="cpu").step(st)
    adv = _solo(("hadv_upwind",), st)
    full = _solo(("hadv_upwind", "hdiff"), st)
    for n in fields.PROGNOSTIC:
        want = full if n in ("u", "v") else adv
        assert torch.equal(out.fields[n], want.fields[n]), n
        assert torch.equal(out.stage_tens[n], st.stage_tens[n]), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kstep_round_is_two_rounds(dtype):
    """The k=2 round equals two one-step rounds, and
    its `run(state, 3)` (a round and a one-step tail) three."""
    st = _port_state(seed=5, dtype=dtype)
    one = compile(_pipe(FLAGSHIP, dtype=dtype), device="cpu")
    two = compile(_pipe(FLAGSHIP, dtype=dtype, variant="kstep", k_steps=2),
                  device="cpu")
    assert (two.variant, two.k_steps) == ("kstep", 2)
    assert two.pallas_calls_per_round == 2 * one.pallas_calls_per_round == 6
    assert two.compute_grid == (3, 20, 20)
    _assert_equal(two.step(st), one.step(one.step(st)))
    _assert_equal(two.run(st, 3), one.run(st, 3))
    assert two.round_plan(1).op_def is one.op_def


def test_asselin_chain_pads_and_launches_nothing():
    prog = _pipe(("asselin",))
    opdef = get_stencil_op(prog.op)
    assert opdef.resolved_rides(1) == () and opdef.halo == 0
    assert "kstep" not in opdef.variants
    plan = compile(prog, device="cpu")
    assert plan.pallas_calls_per_round == 0
    assert plan.compute_grid == GRID
    st = _port_state(seed=4)
    _assert_equal(plan.step(st), _solo(("asselin",), st))


def test_unfused_chain_is_the_whole_state_chain_on_the_cpu():
    """On the CPU both variants take the plain versions: the unfused
    chain (no launches anywhere) gives the whole-state chain's bits."""
    st = _port_state(seed=6)
    unfused = compile(_pipe(FLAGSHIP, variant="unfused"), device="cpu")
    assert unfused.pallas_calls_per_round == 0
    assert unfused.report()["model"] is None
    _build.reset_launches()
    _assert_equal(unfused.step(st),
                  compile(_pipe(FLAGSHIP), device="cpu").step(st))
    assert not any(_build.LAUNCHES.values())


def test_measured_tuning_returns_the_chain_untimed(tmp_path, monkeypatch):
    """A chain's plan has no kernel tile (each stage's plan has its own),
    so `tune="measure"` has nothing to time."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    plan = compile(_pipe(FLAGSHIP), device="cpu", tune="measure")
    assert plan.tile is None and plan.report()["tuning"] is None
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2])
def test_cuda_chain_matches_the_cpu_chain(dtype, k):
    """The flagship round on the card launches exactly
    `pallas_calls_per_round` kernels (one hadv, one vadvc, one hdiff a
    step) and agrees with the CPU round: float32 within 2e-4 off the
    fragile points and 0.05 everywhere, bfloat16 within 0.25."""
    _on_card()
    st = _port_state(seed=8, dtype=dtype)
    kw = dict(dtype=dtype, variant="kstep" if k > 1 else "whole_state",
              k_steps=k)
    want = compile(_pipe(FLAGSHIP, **kw), device="cpu").step(st)
    plan = compile(_pipe(FLAGSHIP, **kw), device="cuda")
    _build.reset_launches()
    got = plan.step(_to_device(st, "cuda"))
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {**{n: 0 for n in _build.LAUNCHES},
                               "hadv": k, "vadvc": k, "hdiff": k}
    assert sum(_build.LAUNCHES.values()) == plan.pallas_calls_per_round
    fragile = _fragile(st, k) if dtype == "float32" else None
    for part in ("fields", "stage_tens"):
        for n in fields.PROGNOSTIC:
            err = (getattr(got, part)[n].cpu().float()
                   - getattr(want, part)[n].float()).abs().numpy()
            if dtype == "bfloat16":
                assert err.max() <= BF16_TOL, (part, n)
                continue
            assert err[~fragile[n]].max(initial=0.0) <= FP32_TOL, (part, n)
            assert err.max() <= LOOSE, (part, n)


@pytest.mark.cuda
@pytest.mark.parametrize("chain", [FLAGSHIP, BINDING,
                                   ("vadvc", "asselin", "hdiff")],
                         ids=_chain_id)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_chain_is_its_solo_sequence(chain, dtype):
    """On the card too a chain equals its solo plans bit for bit; the
    unbound fields of a binding pass through."""
    _on_card()
    st = _to_device(_port_state(seed=9, dtype=dtype), "cuda")
    out = compile(_pipe(chain, dtype=dtype), device="cuda").step(st)
    ops = [c if isinstance(c, str) else c[0] for c in chain]
    if chain == BINDING:
        adv = _solo(ops[:1], st, device="cuda", dtype=dtype)
        full = _solo(ops, st, device="cuda", dtype=dtype)
        for n in fields.PROGNOSTIC:
            want = full if n in ("u", "v") else adv
            assert torch.equal(out.fields[n], want.fields[n]), n
        return
    _assert_equal(out, _solo(ops, st, device="cuda", dtype=dtype))


@pytest.mark.cuda
def test_cuda_unfused_chain_launches_nothing():
    _on_card()
    st = _to_device(_port_state(seed=10), "cuda")
    plan = compile(_pipe(FLAGSHIP, variant="unfused"), device="cuda")
    _build.reset_launches()
    out = plan.step(st)
    torch.cuda.synchronize()
    assert not any(_build.LAUNCHES.values())
    want = compile(_pipe(FLAGSHIP), device="cuda").step(st)
    for n in fields.PROGNOSTIC:
        assert (out.stage_tens[n] - want.stage_tens[n]).abs().max() <= \
            FP32_TOL
