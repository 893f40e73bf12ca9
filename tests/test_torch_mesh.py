"""The port's mesh rounds (`compile(program, mesh=...)`) against the JAX
package's, and their own bit contracts.

The JAX side needs four devices, so it runs once for the whole file in a
subprocess with four forced host devices (`reference`), which compiles
each case on a JAX mesh, steps one round from the same state and writes
the gathered fields, stage tendencies and `report()` to an `.npz`. The
port compiles the same program on a mesh of four CPU shards
(`make_mesh(..., devices=["cpu"] * 4)`) and runs the plain versions; its
Pallas counterpart runs in interpret mode. Cases, at (4, 16, 16), ensemble
2:

* on a (2, 2) ("data", "model") mesh every op and variant: dycore
  unfused / per_field / whole_state / kstep, hdiff unfused / per_field /
  whole_state / kstep, vadvc unfused / per_field / whole_state,
  vadvc_update, hadv_upwind and asselin unfused / whole_state, the
  flagship chain `hadv_upwind -> vadvc_update -> hdiff` (whole_state and a
  k=2 round) and an asselin-only chain that elides every exchange; the
  dycore in bfloat16 and with a bfloat16 wire, the flagship with one;
* on (4, 1), (1, 4) and a ("pod", "data", "model") (2, 1, 2) mesh the
  whole-state plan of every op, the dycore k=2 round (where the slab holds
  its halo) and the flagship chain.

Each round is held to the reference at the tolerances of
`tests/test_torch_program.py` (the dycore and the chains: at most 2 points
a field over them, where a flux limiter may flip, and every point within
0.05); `report()`'s `exchange`, `collectives_per_round`,
`pallas_calls_per_round`, `local_grid`, `compute_grid` and
`exchange_model` equal the reference's, and the rides the round made
(`domain.RIDES`) equal `collectives_per_round`. A halo deeper than the
slab is refused by both.

Inside the port, bit for bit: a round does not depend on the tile; a
(4, 1) round equals a (2, 1) round (shrinking a sharded axis); a (1, 1)
mesh is the single-device plan (wrap padding); a chain's mesh round is
its stages' solo mesh plans in sequence; a k-step plan's `run` with a
ragged tail is its rounds. The `cuda` cases repeat these on the card, on
four shards of one device, and count the launches (the report's per
shard, on every shard).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_mesh
from repro_torch.weather import domain, fields
from repro_torch.weather.convert import state_from_numpy
from repro_torch.weather.pipeline import PipelineProgram
from repro_torch.weather.program import (StencilProgram, compile,
                                         compile_with_fallback)

ROOT = Path(__file__).resolve().parents[1]
GRID, E = (4, 16, 16), 2
CHAIN_COEFF = 0.05
LOOSE = 0.05          # |coeff * flux| scale at a flipped limiter branch
TOL = {"dycore": 1e-5, "hdiff": 1e-5, "vadvc": 2e-4, "vadvc_update": 2e-4,
       "hadv_upwind": 1e-5, "asselin": 1e-5, "flagship": 2e-4,
       "asselin_chain": 1e-5}
BF16_TOL = {"dycore": 0.25}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "pod": ((2, 1, 2), ("pod", "data", "model"))}
CHAINS = {"flagship": ("hadv_upwind", "vadvc_update", "hdiff"),
          "asselin_chain": ("asselin",)}
EVERY = [("dycore", "unfused", 1), ("dycore", "per_field", 1),
         ("dycore", "whole_state", 1), ("dycore", "kstep", 2),
         ("hdiff", "unfused", 1), ("hdiff", "per_field", 1),
         ("hdiff", "whole_state", 1), ("hdiff", "kstep", 2),
         ("vadvc", "unfused", 1), ("vadvc", "per_field", 1),
         ("vadvc", "whole_state", 1), ("vadvc_update", "unfused", 1),
         ("vadvc_update", "whole_state", 1), ("hadv_upwind", "unfused", 1),
         ("hadv_upwind", "whole_state", 1), ("asselin", "unfused", 1),
         ("asselin", "whole_state", 1), ("flagship", "whole_state", 1),
         ("flagship", "kstep", 2), ("asselin_chain", "whole_state", 1)]
WHOLE = [c for c in EVERY if c[1] == "whole_state"
         and c[0] != "asselin_chain"] + [("dycore", "kstep", 2)]
CASES = ([("2x2",) + c + ("float32", None) for c in EVERY]
         + [("2x2", "dycore", "whole_state", 1, "bfloat16", None),
            ("2x2", "dycore", "whole_state", 1, "float32", "bfloat16"),
            ("2x2", "flagship", "whole_state", 1, "float32", "bfloat16")]
         + [(m,) + c + ("float32", None) for m in ("4x1", "1x4", "pod")
            for c in WHOLE if not (m == "1x4" and c[1] == "kstep")])
# (mesh, op, variant, k): refused by both, the halo outgrows the slab
TOO_DEEP = [("1x4", "dycore", "kstep", 2), ("4x1", "hdiff", "kstep", 3)]
REPORT_KEYS = ("variant", "k_steps", "distributed", "mesh_axes",
               "local_grid", "compute_grid", "exchange",
               "pallas_calls_per_round", "collectives_per_round")


def _key(case):
    return "-".join(str(c) for c in case)


def _program(op, variant, k, dtype="float32", wire=None):
    kw = dict(grid_shape=GRID, ensemble=E, variant=variant, k_steps=k,
              dtype=dtype, exchange_dtype=wire)
    if op in CHAINS:
        return PipelineProgram(stages=CHAINS[op], coeff=CHAIN_COEFF, **kw)
    return StencilProgram(op=op, **kw)


_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.weather import domain, fields
from repro.weather.pipeline import PipelineProgram
from repro.weather.program import StencilProgram, compile

cases, meshes, chains, keys, too_deep = (json.loads(a) for a in sys.argv[1:6])
grid, E, coeff = tuple(json.loads(sys.argv[6])), int(sys.argv[7]), \
    float(sys.argv[8])
inp = np.load(sys.argv[9])
names = fields.PROGNOSTIC
made = {}
def mesh(m):
    if m not in made:
        made[m] = make_mesh(*meshes[m])
    return made[m]
def state(dtype):
    cast = lambda a: jnp.asarray(a).astype(jnp.dtype(dtype))
    d = lambda part: {n: cast(inp[f"{part}/{n}"]) for n in names}
    return fields.WeatherState(fields=d("fields"), wcon=cast(inp["wcon"]),
                               tens=d("tens"), stage_tens=d("stage_tens"))
def program(op, variant, k, dtype="float32", wire=None):
    kw = dict(grid_shape=grid, ensemble=E, variant=variant, k_steps=k,
              dtype=dtype, exchange_dtype=wire)
    if op in chains:
        return PipelineProgram(stages=tuple(chains[op]), coeff=coeff, **kw)
    return StencilProgram(op=op, **kw)
out, reports = {}, {}
for c in cases:
    m, op, variant, k, dtype, wire = c
    key = "-".join(str(x) for x in c)
    plan = compile(program(op, variant, k, dtype, wire), mesh=mesh(m))
    res = plan.step(domain.shard_state(state(dtype), plan.mesh,
                                       plan.state_spec))
    for part in ("fields", "stage_tens"):
        for n in names:
            out[f"{key}/{part}/{n}"] = np.asarray(
                getattr(res, part)[n]).astype(np.float32)
    # report()'s structural keys, read off the plan: the reference's
    # report() raises at a mesh's unfused dycore (no whole-state tile to
    # model its traffic at)
    rep = {"variant": plan.variant, "k_steps": plan.k_steps,
           "distributed": plan.distributed,
           "mesh_axes": list(plan.mesh_axes),
           "local_grid": list(plan.local_grid),
           "compute_grid": list(plan.compute_grid),
           "exchange": plan.exchange.describe(),
           "pallas_calls_per_round": plan.pallas_calls_per_round,
           "collectives_per_round": plan.collectives_per_round,
           "exchange_model": (plan.op_def.exchange_model(plan)
                              if plan.exchange.mode == "packed" else None)}
    reports[key] = {k_: rep[k_] for k_ in keys + ["exchange_model"]}
refused = {}
for m, op, variant, k in too_deep:
    try:
        compile(program(op, variant, k), mesh=mesh(m))
        refused["-".join((m, op))] = None
    except ValueError as e:
        refused["-".join((m, op))] = str(e)
np.savez(sys.argv[10], **out)
print("RESULT " + json.dumps({"reports": reports, "refused": refused}))
"""


def _input_state():
    """The input state as numpy: smooth fields, tendencies and nonzero
    stage tendencies from the port's recipe, fp32."""
    g = torch.Generator().manual_seed(0)
    st = fields.initial_state(g, GRID, ensemble=E, device="cpu")
    noise = fields.initial_state(g, GRID, ensemble=E, device="cpu")
    arrays = {"wcon": st.wcon.numpy()}
    for n in fields.PROGNOSTIC:
        arrays[f"fields/{n}"] = st.fields[n].numpy()
        arrays[f"tens/{n}"] = st.tens[n].numpy()
        arrays[f"stage_tens/{n}"] = noise.tens[n].numpy()
    return arrays


def _port_state(arrays, dtype="float32"):
    d = lambda part: {n: arrays[f"{part}/{n}"] for n in fields.PROGNOSTIC}
    st = state_from_numpy(d("fields"), arrays["wcon"], d("tens"),
                          d("stage_tens"), device="cpu")
    return st if dtype == "float32" else _cast(st, dtype)


def _cast(st, dtype):
    dt = fields.torch_dtype(dtype)
    d = lambda m: fields.field_views(torch.stack(list(m.values()), 1).to(dt),
                                     tuple(m))
    return fields.WeatherState(fields=d(st.fields), wcon=st.wcon.to(dt),
                               tens=d(st.tens), stage_tens=d(st.stage_tens))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    arrays = _input_state()
    np.savez(tmp / "in.npz", **arrays)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           # one thread: the suite's other workers share the cores
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1"}
    args = [json.dumps(CASES), json.dumps(MESHES), json.dumps(CHAINS),
            json.dumps(list(REPORT_KEYS)), json.dumps(TOO_DEEP),
            json.dumps(GRID), str(E), str(CHAIN_COEFF),
            str(tmp / "in.npz"), str(tmp / "out.npz")]
    r = subprocess.run([sys.executable, "-c", _SCRIPT] + args, env=env,
                       capture_output=True, text=True, timeout=900)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and line, r.stderr[-3000:]
    return arrays, np.load(tmp / "out.npz"), json.loads(line[0][7:])


def _mesh(name, devices=("cpu",) * 4):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=list(devices))


def _close(op, dtype, got, want):
    """`got` within `want`'s tolerance: the dycore and the flagship chain
    may flip a flux limiter at up to 2 points a field."""
    for part in ("fields", "stage_tens"):
        for n in fields.PROGNOSTIC:
            a = getattr(got, part)[n].float().numpy()
            b = want[f"{part}/{n}"]
            err = np.abs(a - b)
            if dtype == "bfloat16":
                assert err.max() <= BF16_TOL.get(op, 0.15), (part, n)
            elif op in ("dycore", "flagship") and part == "fields":
                assert int((err > TOL[op]).sum()) <= 2, (part, n)
                assert err.max() < LOOSE, (part, n, err.max())
            else:
                assert err.max() <= TOL[op], (part, n, err.max())


def _flat(d, prefix=""):
    """A nested dict of numbers as one flat dict (None as is)."""
    if d is None:
        return None
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_mesh_round_matches_the_reference(reference, case):
    arrays, out, res = reference
    m, op, variant, k, dtype, wire = case
    key = _key(case)
    plan = compile(_program(op, variant, k, dtype, wire), mesh=_mesh(m))
    st = _port_state(arrays, dtype)
    domain.reset_rides()
    got = domain.gather_state(plan.step(st))
    rep, want_rep = plan.report(), res["reports"][key]
    assert domain.RIDES["rides"] == plan.collectives_per_round
    for k_ in REPORT_KEYS:
        assert rep[k_] == want_rep[k_], k_
    assert _flat(rep["exchange_model"]) == pytest.approx(
        _flat(want_rep["exchange_model"]), rel=1e-12)
    want = {f"{part}/{n}": out[f"{key}/{part}/{n}"]
            for part in ("fields", "stage_tens") for n in fields.PROGNOSTIC}
    _close(op, dtype, got, want)


@pytest.mark.parametrize("case", TOO_DEEP, ids=_key)
def test_halo_deeper_than_the_slab_is_refused(reference, case):
    _, _, res = reference
    m, op, variant, k = case
    assert "halo" in res["refused"]["-".join((m, op))]
    with pytest.raises(ValueError, match="deep halo"):
        compile(_program(op, variant, k), mesh=_mesh(m))


def test_bf16_wire_rounds_only_the_halo(reference):
    """The bfloat16 wire moves the result, by less than 0.1 (the
    reference's bound): the cast stays in the received halo ring."""
    arrays, _, _ = reference
    st = _port_state(arrays)
    for op in ("dycore", "flagship"):
        f32, b16 = (domain.gather_state(compile(
            _program(op, "whole_state", 1, wire=w), mesh=_mesh("2x2")
        ).step(st)) for w in (None, "bfloat16"))
        errs = [float((f32.fields[n] - b16.fields[n]).abs().max())
                for n in fields.PROGNOSTIC]
        assert 0.0 < max(errs) < 0.1, (op, errs)


# ---------------------------------------------------------------------------
# The port's own contracts
# ---------------------------------------------------------------------------


def _state(dtype="float32", device="cpu"):
    st = _port_state(_input_state(), dtype)
    if device == "cpu":
        return st
    d = lambda m: fields.field_views(
        torch.stack(list(m.values()), 1).to(device), tuple(m))
    return fields.WeatherState(fields=d(st.fields), wcon=st.wcon.to(device),
                               tens=d(st.tens), stage_tens=d(st.stage_tens))


def _assert_equal(a, b):
    for part in ("fields", "stage_tens"):
        for n in fields.PROGNOSTIC:
            assert torch.equal(getattr(a, part)[n].cpu(),
                               getattr(b, part)[n].cpu()), (part, n)


def _gathered(plan, st, rounds=1):
    for _ in range(rounds):
        st = plan.step(st)
    return domain.gather_state(st)


TILED = [("dycore", "whole_state", 1, (8, 8)), ("dycore", "kstep", 2, (4, 8)),
         ("hdiff", "whole_state", 1, (4, 8)), ("hdiff", "kstep", 2, (4, 8)),
         ("vadvc", "whole_state", 1, (1, 4)),
         ("hadv_upwind", "whole_state", 1, (4, 4))]


@pytest.mark.parametrize("op,variant,k,request_", TILED,
                         ids=lambda v: str(v))
def test_mesh_round_is_tile_independent(op, variant, k, request_):
    mesh = _mesh("2x2")
    prog = _program(op, variant, k)
    a, b = compile(prog, mesh=mesh), compile(prog, mesh=mesh, _tile=request_)
    assert a.tile != b.tile
    st = _state()
    _assert_equal(_gathered(a, st), _gathered(b, st))


@pytest.mark.parametrize("case", EVERY, ids=_key)
def test_shrinking_a_sharded_axis_keeps_bits(case):
    """A (4, 1) round equals a (2, 1) round, and (1, 4) a (1, 2) one
    (where the slab holds the halo): the property failover relies on."""
    op, variant, k = case
    prog = _program(op, variant, k)
    st = _state()
    for big, small in (((4, 1), (2, 1)), ((1, 4), (1, 2))):
        try:
            pb = compile(prog, mesh=make_mesh(big, ("data", "model"),
                                              devices=["cpu"] * 4))
        except ValueError:
            continue
        ps = compile(prog, mesh=make_mesh(small, ("data", "model"),
                                          devices=["cpu"] * 2))
        _assert_equal(_gathered(pb, st), _gathered(ps, st))


@pytest.mark.parametrize("case", EVERY, ids=_key)
def test_one_shard_mesh_is_wrap_padding(case):
    op, variant, k = case
    prog = _program(op, variant, k)
    st = _state()
    one = compile(prog, mesh=make_mesh((1, 1), ("data", "model"),
                                       devices=["cpu"]))
    _assert_equal(_gathered(one, st), compile(prog, device="cpu").step(st))
    assert one.collectives_per_round == 0


@pytest.mark.parametrize("mesh", ["2x2", "4x1", "pod"])
def test_chain_mesh_round_is_its_solo_mesh_plans(mesh):
    """The flagship chain's mesh round: one packed exchange for the chain,
    fields and stage tendencies bit for bit those of its stages' own mesh
    plans one after the other (rides: one pair a sharded direction
    against one a stage)."""
    m = _mesh(mesh)
    st = _state()
    plan = compile(_program("flagship", "whole_state", 1), mesh=m)
    domain.reset_rides()
    got = _gathered(plan, st)
    assert domain.RIDES["rides"] == plan.collectives_per_round
    seq = st
    for op in CHAINS["flagship"]:
        seq = compile(StencilProgram(grid_shape=GRID, ensemble=E,
                                     coeff=CHAIN_COEFF, op=op, k_steps=1),
                      mesh=m).step(seq)
    _assert_equal(got, domain.gather_state(seq))


@pytest.mark.parametrize("op", ["dycore", "hdiff", "flagship"])
def test_kstep_run_with_a_tail_is_its_rounds(op):
    """`run(state, 3)` of a k=2 mesh plan (a k=2 round and a k=1 tail)
    equals three whole-state mesh rounds: bit for bit for hdiff and the
    chain; the dycore's k-step round carries fp32 between its steps, so
    within its tolerance."""
    m = _mesh("2x2")
    st = _state()
    got = domain.gather_state(compile(_program(op, "kstep", 2), mesh=m)
                              .run(st, 3))
    want = _gathered(compile(_program(op, "whole_state", 1), mesh=m), st, 3)
    if op != "dycore":
        _assert_equal(got, want)
        return
    _close("dycore", "float32", got,
           {f"{p}/{n}": getattr(want, p)[n].numpy()
            for p in ("fields", "stage_tens") for n in fields.PROGNOSTIC})


def test_the_state_contract():
    """A mesh plan takes a plain state (placed first) or a sharded one, and
    returns a sharded one; a single-device plan refuses a sharded one; the
    plan's spec keeps z whole and puts the ensemble on "pod"."""
    st = _state()
    m = _mesh("pod")
    plan = compile(_program("hdiff", "whole_state", 1), mesh=m)
    assert plan.state_spec == ("pod", None, "data", "model")
    assert compile(_program("hdiff", "whole_state", 1),
                   mesh=_mesh("2x2")).state_spec == (None, None, "data",
                                                     "model")
    out = plan.step(st)
    assert isinstance(out, domain.ShardedState)
    again = plan.step(domain.shard_state(st, m, plan.state_spec))
    _assert_equal(domain.gather_state(out), domain.gather_state(again))
    with pytest.raises(ValueError, match="sharded"):
        compile(_program("hdiff", "whole_state", 1), device="cpu").step(out)
    with pytest.raises(ValueError, match="divide"):
        compile(StencilProgram(grid_shape=(4, 15, 16), ensemble=E),
                mesh=_mesh("2x2"))
    with pytest.raises(ValueError, match="no axis"):
        compile(_program("hdiff", "whole_state", 1), mesh=m, ax_y="rows")
    with pytest.raises(ValueError, match="mesh's devices"):
        compile(_program("hdiff", "whole_state", 1), mesh=m, device="cuda")


def test_auto_k_tune_and_fallback_on_a_mesh(tmp_path, monkeypatch):
    """`k_steps="auto"` resolves on a mesh (the exchange model's pick, a
    legal k) and its round is within tolerance of k whole-state rounds;
    `tune="measure"` times the mesh round and keeps the mesh;
    `compile_with_fallback(mesh=)` compiles on it."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    m = _mesh("2x2")
    auto = compile(StencilProgram(grid_shape=GRID, ensemble=E), mesh=m)
    assert isinstance(auto.k_steps, int) and auto.k_steps >= 1
    st = _state()
    ref = _gathered(compile(_program("dycore", "whole_state", 1), mesh=m),
                    st, auto.k_steps)
    _close("dycore", "float32", _gathered(auto, st),
           {f"{p}/{n}": getattr(ref, p)[n].numpy()
            for p in ("fields", "stage_tens") for n in fields.PROGNOSTIC})
    tuned = compile(_program("hdiff", "whole_state", 1), mesh=m,
                    tune="measure")
    assert tuned.mesh == m and tuned.report()["tuning"]["mode"] == "measure"
    plan, fallback, errors = compile_with_fallback(
        _program("vadvc", "whole_state", 1), mesh=m)
    assert plan.mesh == m and fallback is None and not errors


# ---------------------------------------------------------------------------
# On the card: four shards of one device
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", EVERY, ids=_key)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mesh_round(case, dtype, cuda):
    """On four shards of the card: the round within tolerance of the CPU's
    mesh round, the (1, 1) mesh bit for bit the single-device plan, the
    launches the report's on every shard and the rides its count."""
    op, variant, k = case
    prog = _program(op, variant, k, dtype)
    st = _state(dtype)
    want = _gathered(compile(prog, mesh=_mesh("2x2")), st)
    plan = compile(prog, mesh=_mesh("2x2", [cuda] * 4))
    sharded = domain.shard_state(_state(dtype, cuda), plan.mesh,
                                 plan.state_spec)
    torch.cuda.synchronize()
    _build.reset_launches()
    domain.reset_rides()
    out = plan.step(sharded)
    torch.cuda.synchronize()
    assert sum(_build.LAUNCHES.values()) == 4 * plan.pallas_calls_per_round
    assert domain.RIDES["rides"] == plan.collectives_per_round
    _close(op, dtype, domain.gather_state(out),
           {f"{p}/{n}": getattr(want, p)[n].float().numpy()
            for p in ("fields", "stage_tens") for n in fields.PROGNOSTIC})
    one = compile(prog, mesh=make_mesh((1, 1), ("data", "model"),
                                       devices=[cuda]))
    _assert_equal(_gathered(one, _state(dtype, cuda)),
                  compile(prog, device=cuda).step(_state(dtype, cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("op,variant,k,request_", TILED,
                         ids=lambda v: str(v))
def test_cuda_mesh_round_is_tile_independent(op, variant, k, request_, cuda):
    mesh = _mesh("2x2", [cuda] * 4)
    prog = _program(op, variant, k)
    a, b = compile(prog, mesh=mesh), compile(prog, mesh=mesh, _tile=request_)
    st = _state(device=cuda)
    _assert_equal(_gathered(a, st), _gathered(b, st))


@pytest.mark.cuda
def test_cuda_chain_and_shrunk_mesh_keep_bits(cuda):
    st = _state(device=cuda)
    m = _mesh("2x2", [cuda] * 4)
    got = _gathered(compile(_program("flagship", "whole_state", 1), mesh=m),
                    st)
    seq = st
    for op in CHAINS["flagship"]:
        seq = compile(StencilProgram(grid_shape=GRID, ensemble=E,
                                     coeff=CHAIN_COEFF, op=op, k_steps=1),
                      mesh=m).step(seq)
    _assert_equal(got, domain.gather_state(seq))
    prog = _program("dycore", "whole_state", 1)
    big = compile(prog, mesh=make_mesh((4, 1), ("data", "model"),
                                       devices=[cuda] * 4))
    small = compile(prog, mesh=make_mesh((2, 1), ("data", "model"),
                                         devices=[cuda] * 2))
    _assert_equal(_gathered(big, st), _gathered(small, st))
