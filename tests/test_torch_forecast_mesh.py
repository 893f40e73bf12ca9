"""The port's forecast engine on a mesh (`ForecastEngine(mesh=...)`) against
its own contracts and the JAX package's engine.

On meshes of CPU shards (`make_mesh(..., devices=["cpu"] * n)`):

* the slot guard of a sharded lane (a partial pass a distinct block at its
  global offset, one combine) gives the JAX package's `slot_guard` of the
  gathered state exactly, in fp32 and bf16, on (1, 1), (2, 2), (4, 1),
  (1, 4) and a ("pod", "data", "model") mesh with the ensemble split over
  "pod" and with it replicated (where counting the copies would cancel);
* a mesh drain is bit-equal to solo runs on the mesh and, in fp32, to the
  single-device plan, compiling once a program;
* the JAX package's kill-a-device scenario (`tests/test_mesh_failover.py`):
  one failover (2, 2) -> (2, 1), logical device 3 lost, no lane failure,
  every result bit-equal to solo runs on the original mesh and (fp32) to
  the single-device plan, which the reference's own test does not reach;
  in bf16 the pattern-keeping (4, 1) -> (2, 1) and the axis-collapsing
  (2, 2) -> (2, 1), each held bit for bit to the original mesh's solo runs;
* failover off, and a loss that names no device (the probe finds every
  logical device alive), fail only the lane;
* wire corruption of an idle slot is scrubbed, of a rolled-back slot
  quarantined, let through with the guard off, at the JAX package's
  positions; a straggler past the round deadline recovers;
* a round that fails part-way leaves the lane at its pre-round bits (the
  failover's pivot), and a rolled-back slot keeps its bits;
* elastic restore 1 -> 4, 4 -> 1 and 4 -> 2 drains bit-equal.

Against the JAX engine, in one subprocess with four forced host devices:
a scripted mesh fault run (a persistent device loss and a wire corruption)
gives the same failover, counters and statuses, and fields within the fp32
stencil tolerance; a checkpoint the JAX engine wrote on a (2, 2) mesh
restores and drains in the port, and one the port wrote on its (2, 2) mesh
drains in the JAX engine. The `cuda` cases hold the guard kernel with
offsets, the combined kernel digest and a drain on `["cuda:0"] * 4` on the
card.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.testing.faults import FaultInjector as JInjector
from repro.testing.faults import FaultSpec as JSpec
from repro.weather import fields as jfields
from repro.weather import program as jprog
from repro_torch.kernels import _build
from repro_torch.kernels.dycore_fused import ops as fused_ops
from repro_torch.kernels.dycore_fused import ref as fused_ref
from repro_torch.kernels.slot_guard import ops as guard_ops
from repro_torch.kernels.slot_guard import ref as guard_ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve.forecast import ForecastEngine, ForecastRequest
from repro_torch.testing.faults import (FaultInjector, FaultSpec,
                                        InjectedDeviceLoss)
from repro_torch.weather import convert, domain, fields
from repro_torch.weather import program as wprog
from repro_torch.weather.program import StencilProgram, plan_cache_key

ROOT = Path(__file__).resolve().parents[1]
GRID = (4, 16, 16)
TOL = 1e-5      # the main path's fp32 tolerance (tests/test_kernels_*.py)
AXES = ("data", "model")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _mesh(shape, axes=AXES, device="cpu"):
    return make_mesh(shape, axes, devices=[device] * int(np.prod(shape)))


def _state(seed, dtype="float32", ensemble=1, grid=GRID):
    return fields.initial_state(torch.Generator().manual_seed(seed), grid,
                                ensemble=ensemble, dtype=dtype, device="cpu")


def _to_port(js):
    d = lambda m: {k: np.asarray(v) for k, v in m.items()}
    return convert.state_from_numpy(d(js.fields), np.asarray(js.wcon),
                                    d(js.tens), d(js.stage_tens),
                                    device="cpu")


def _bits(t):
    t = t.detach().cpu().contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _equal(a, b):
    """Every leaf bit for bit (a NaN equals its own bits)."""
    la, lb = fields.state_leaves(a), fields.state_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _solo_mesh(prog, state, steps, mesh):
    plan = wprog.compile(prog, mesh=mesh)
    return domain.gather_state(
        plan.run(domain.shard_state(state, mesh, plan.state_spec), steps))


def _single(prog, state, steps):
    return wprog.compile(prog, device="cpu").run(state, steps)


# ---------------------------------------------------------------------------
# The guard over shards against the JAX package's
# ---------------------------------------------------------------------------

# name: (mesh shape, axis names, ax_e)
LAYOUTS = {"1x1": ((1, 1), AXES, "pod"), "2x2": ((2, 2), AXES, "pod"),
           "4x1": ((4, 1), AXES, "pod"), "1x4": ((1, 4), AXES, "pod"),
           "pod_split": ((2, 1, 2), ("pod",) + AXES, "pod"),
           "pod_copies": ((2, 1, 2), ("pod",) + AXES, None)}


def _guard_state(dtype):
    js = jfields.initial_state(jax.random.PRNGKey(7), GRID, ensemble=4,
                               dtype=jnp.dtype(dtype))
    f, t, s = dict(js.fields), dict(js.tens), dict(js.stage_tens)
    f["u"] = f["u"].at[1, 0, 3, 5].set(jnp.nan)
    t["t"] = t["t"].at[2, 1, 12, 9].set(5e6)
    s["pp"] = s["pp"].at[3, 2, 9, 14].set(-0.0)
    return jfields.WeatherState(fields=f, wcon=js.wcon, tens=t, stage_tens=s)


def _spec(mesh, ax_e):
    return (ax_e if ax_e in mesh.axis_names else None, None) + AXES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_digest_matches_jax(layout, dtype):
    js = _guard_state(dtype)
    want_ok, want_fp = (np.asarray(a) for a in jprog.slot_guard(js, 1e6))
    assert want_ok.tolist() == [True, False, False, True]
    shape, axes, ax_e = LAYOUTS[layout]
    mesh = _mesh(shape, axes)
    sharded = domain.shard_state(_to_port(js), mesh, _spec(mesh, ax_e))
    ok, fp = wprog.slot_guard(sharded, 1e6)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(fp.numpy(), want_fp.astype(np.int64))
    assert wprog.slot_validity(sharded, 1e6).tolist() == want_ok.tolist()
    if layout == "pod_copies":
        # the "pod" shards hold copies: each block enters the digest once;
        # entering both copies would cancel every XOR word
        assert domain.distinct_shards(sharded) == [0, 1]
        offsets = domain.block_offsets(sharded)
        every = [(fields.state_leaves(sh),) + off
                 for sh, off in zip(sharded.shards, offsets)]
        assert guard_ops.slot_guard_blocks(every, 4, 1e6)[1].tolist() != \
            fp.tolist()


def test_guard_words_compose_to_the_whole_state():
    """The plain partial words of any split, combined, are the single
    pass's guard; a block's digest hashes its global positions."""
    leaves = fields.state_leaves(_state(3, ensemble=3))
    leaves[2][1, 1, 4, 4] = float("inf")
    whole = guard_ref.slot_guard(leaves, 1e6)
    thr = guard_ref.threshold(torch.float32, 1e6)
    words = torch.zeros((4, 3, len(leaves), 2), dtype=torch.int64)
    for s, (y0, x0) in enumerate([(0, 0), (0, 8), (8, 0), (8, 8)]):
        words[s] = guard_ref.guard_words(
            [t[..., y0:y0 + 8, x0:x0 + 8] for t in leaves], y0, x0)
    got = guard_ref.guard_finish(words, thr)
    assert got[0].tolist() == whole[0].tolist() == [True, False, True]
    assert got[1].tolist() == whole[1].tolist()
    moved = guard_ref.leaf_fp(leaves[0][..., 8:, :], 0, 0)
    assert moved.tolist() != guard_ref.leaf_fp(leaves[0][..., 8:, :], 8,
                                               0).tolist()


# ---------------------------------------------------------------------------
# Serving on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_drain_bit_equal_to_solo_and_single_device(dtype, monkeypatch):
    calls = []
    real_compile = wprog.compile

    def spy(program, *a, **kw):
        calls.append(program)
        return real_compile(program, *a, **kw)

    monkeypatch.setattr(wprog, "compile", spy)
    mesh = _mesh((2, 2))
    progs = [StencilProgram(grid_shape=GRID, dtype=dtype),
             StencilProgram(grid_shape=GRID, op="hdiff", dtype=dtype)]
    eng = ForecastEngine(slots=2, mesh=mesh)
    assert eng.device == torch.device("cpu")
    reqs = []
    for i, steps in enumerate([5, 2, 3, 4, 1, 6]):
        prog = progs[i % 2]
        st_ = _state(40 + i, dtype)
        reqs.append((eng.submit(ForecastRequest(program=prog, state=st_,
                                                steps=steps)), prog, st_))
    res = eng.drain()
    keys = {plan_cache_key(p, ensemble=2) for p in progs}
    assert sum(p in keys for p in calls) == 2
    s = eng.stats()
    assert s["plan_cache_misses"] == 2 and s["mesh_devices"] == [0, 1, 2, 3]
    assert s["fingerprint_divergence"] == s["scrubbed_idle_slots"] == 0
    assert s["fallback_compiles"] == 0 and s["failovers"] == []
    assert all(isinstance(ln.batch, domain.ShardedState)
               for ln in eng._lanes.values())
    for rid, prog, st_ in reqs:
        r = res[rid]
        assert r.status == "ok" and r.state.wcon.device.type == "cpu"
        assert _equal(r.state, _solo_mesh(prog, st_, r.steps, mesh)), rid
        if dtype == "float32":
            assert _equal(r.state, _single(prog, st_, r.steps)), rid


def test_mesh_engine_refuses_another_kind_of_device():
    with pytest.raises(ValueError, match="cpu"):
        ForecastEngine(slots=2, mesh=_mesh((2, 2)), device="cuda")
    with pytest.raises(TypeError, match="Mesh"):
        ForecastEngine(slots=2, mesh="data")


KILL_CASES = {
    # (dtype, mesh shape, the failover's shape, held to the single device)
    "fp32_2x2": ("float32", (2, 2), [2, 1], True),
    "bf16_4x1": ("bfloat16", (4, 1), [2, 1], False),
    "bf16_2x2": ("bfloat16", (2, 2), [2, 1], False),
}


@pytest.mark.parametrize("case", sorted(KILL_CASES))
def test_kill_device_failover_keeps_every_request_bit_exact(case):
    dtype, shape, to_shape, single = KILL_CASES[case]
    mesh = _mesh(shape)
    prog = StencilProgram(grid_shape=GRID, dtype=dtype)
    states = [_state(s, dtype) for s in (0, 1, 2)]
    steps = (5, 3, 4)
    # device 3 is lost at round 1 and stays lost while the mesh holds it
    inj = FaultInjector([FaultSpec(kind="device_loss", round=1, device=3,
                                   once=False)])
    eng = ForecastEngine(slots=2, mesh=mesh, fault_injector=inj,
                         max_round_retries=1, retry_backoff_s=0.0)
    rids = [eng.submit(ForecastRequest(program=prog, state=s, steps=n))
            for s, n in zip(states, steps)]
    res = eng.drain()
    st = eng.stats()
    assert st["mesh_failovers"] == 1 and st["lane_failures"] == 0, st
    assert st["recovery_rounds"] == 1 and st["requests_preserved"] == 2
    fo = st["failovers"][0]
    assert fo["lost_device"] == 3 and 3 not in fo["to_devices"]
    assert fo["from_devices"] == [0, 1, 2, 3]
    assert fo["from_shape"] == list(shape) and fo["to_shape"] == to_shape
    assert st["mesh_devices"] == fo["to_devices"] == [0, 1]
    assert fo["reshard_ms"] > 0 and st["plan_repins"] == 0
    for rid, s, n in zip(rids, states, steps):
        assert res[rid].status == "ok", res[rid].diagnosis
        assert _equal(res[rid].state, _solo_mesh(prog, s, n, mesh)), rid
        if single:
            assert _equal(res[rid].state, _single(prog, s, n)), rid


def _two_lanes(eng):
    """A dycore and an hdiff request on `eng`, a step a round; returns
    their rids."""
    return [eng.submit(ForecastRequest(
        program=StencilProgram(grid_shape=GRID, op=op, k_steps=1),
        state=_state(50 + i), steps=3))
        for i, op in enumerate(("dycore", "hdiff"))]


@pytest.mark.parametrize("how", ["failover_off", "unnamed_loss"])
def test_loss_without_failover_fails_only_the_lane(how):
    spec = (FaultSpec(kind="device_loss", round=1, device=3, once=False,
                      op="dycore") if how == "failover_off"
            else FaultSpec(kind="device_loss", round=2, once=False,
                           op="dycore"))
    # an unnamed loss: the probe finds every logical device alive (four
    # shards of one device), so it is no mesh fault
    eng = ForecastEngine(slots=2, mesh=_mesh((2, 2)),
                         failover=how == "unnamed_loss",
                         fault_injector=FaultInjector([spec]),
                         max_round_retries=1, retry_backoff_s=0.0)
    dy, hd = _two_lanes(eng)
    res = eng.drain()
    st = eng.stats()
    assert st["lane_failures"] == 1 and st["mesh_failovers"] == 0
    assert st["failovers"] == [] and st["mesh_devices"] == [0, 1, 2, 3]
    assert res[dy].status == "failed"
    assert res[dy].diagnosis["reason"] == "round_failure"
    assert res[dy].steps_done == 1
    assert res[hd].status == "ok"
    assert _equal(res[hd].state, _single(
        StencilProgram(grid_shape=GRID, op="hdiff", k_steps=1), _state(51),
        3))


KSTEP = StencilProgram(grid_shape=GRID, variant="kstep", k_steps=2)
ONE = StencilProgram(grid_shape=GRID, k_steps=1)        # a step a round


def test_wire_corrupt_idle_slot_scrubbed_not_served():
    inj = FaultInjector([FaultSpec(kind="wire_corrupt", round=1, shard=1)])
    eng = ForecastEngine(slots=2, mesh=_mesh((2, 2)), fault_injector=inj)
    prog = ONE
    s = _state(10)
    rid = eng.submit(ForecastRequest(program=prog, state=s, steps=3))
    res = eng.drain()
    st = eng.stats()
    assert inj.log == [{"kind": "wire_corrupt", "op": "dycore", "round": 1,
                        "slot": 1, "shard": 1}]
    assert st["fingerprint_divergence"] == st["scrubbed_idle_slots"] == 1
    assert st["quarantined"] == 0 and res[rid].status == "ok"
    assert _equal(res[rid].state, _single(prog, s, 3))


@pytest.mark.parametrize("guard", [True, False])
def test_wire_corrupt_rolled_back_slot(guard):
    """k=2 with steps 4 and 3: slot 0 sits out the ragged round 1 and is
    rolled back; corruption in its shard-1 rows quarantines it (the guard
    on) or flows into an ok result (the guard off)."""
    inj = FaultInjector([FaultSpec(kind="wire_corrupt", round=1, slot=0,
                                   shard=1)])
    eng = ForecastEngine(slots=2, mesh=_mesh((2, 2)), fault_injector=inj,
                         guard=guard)
    s0, s1 = _state(11), _state(12)
    r0 = eng.submit(ForecastRequest(program=KSTEP, state=s0, steps=4))
    r1 = eng.submit(ForecastRequest(program=KSTEP, state=s1, steps=3))
    res = eng.drain()
    st = eng.stats()
    assert inj.fired("wire_corrupt") == 1
    assert res[r1].status == "ok"
    assert _equal(res[r1].state, _single(KSTEP, s1, 3))
    if guard:
        assert st["fingerprint_divergence"] == st["quarantined"] == 1
        d = res[r0].diagnosis
        assert res[r0].status == "failed"
        assert d["reason"] == "fingerprint_divergence"
        assert d["expected_fp"] != d["observed_fp"]
    else:
        assert res[r0].status == "ok"
        assert st["fingerprint_divergence"] == 0
        assert not _equal(res[r0].state, _single(KSTEP, s0, 4))


@pytest.mark.parametrize("kind", ["wire_corrupt", "poison_nan"])
def test_faults_hit_the_jax_positions_on_a_sharded_lane(kind):
    """The same spec and seed damage the same whole-state positions as
    the JAX injector does on the gathered state, whatever the layout."""
    js = jfields.initial_state(jax.random.PRNGKey(4), GRID, ensemble=4)
    spec = dict(kind=kind, round=0, slot=1, shard=1) if kind == \
        "wire_corrupt" else dict(kind=kind, round=0, slot=1)
    want = JInjector([JSpec(**spec)], seed=9).poison(
        js, "dycore", 0, (0, 1, 2), nonparticipants=(1,), shards=(2, 2))
    for shape, axes in (((2, 2), AXES), ((2, 1, 2), ("pod",) + AXES)):
        mesh = _mesh(shape, axes)
        sharded = domain.shard_state(_to_port(js), mesh,
                                     _spec(mesh, "pod"))
        got = FaultInjector([FaultSpec(**spec)], seed=9).poison(
            sharded, "dycore", 0, (0, 1, 2), nonparticipants=(1,),
            shards=(2, 2))
        assert got is sharded
        assert _equal(domain.gather_state(got), _to_port(want)), shape


def test_straggler_past_the_round_deadline_recovers_on_a_mesh():
    inj = FaultInjector([FaultSpec(kind="straggler", round=2, delay_s=0.3)])
    eng = ForecastEngine(slots=1, mesh=_mesh((2, 2)), fault_injector=inj,
                         retry_backoff_s=0.0)
    prog = ONE
    warm = eng.submit(ForecastRequest(program=prog, state=_state(20),
                                      steps=2))
    eng.drain()                             # rounds 0-1 compile the plan
    eng.round_deadline_s = 0.25
    s = _state(21)
    rid = eng.submit(ForecastRequest(program=prog, state=s, steps=3))
    res = eng.drain()
    st = eng.stats()
    assert inj.fired("straggler") == 1 and st["round_deadline_hits"] == 1
    assert st["round_retries"] == 1 and st["lane_failures"] == 0
    assert res[warm].status == res[rid].status == "ok"
    assert _equal(res[rid].state, _single(prog, s, 3))


def _leaves(sharded):
    return [t.clone() for sh in sharded.shards
            for t in fields.state_leaves(sh)]


def test_a_failed_round_leaves_the_pre_round_pivot(monkeypatch):
    """A round that dies after two of four shards launched wrote nothing
    into the lane: the failover gathers the last round boundary's bits.
    A slot rolled back on a mesh keeps its pre-round bits too."""

    class Spy(ForecastEngine):
        pre, at_pivot, rolled, depth = None, None, [], 0

        def _round(self, lane):
            before = _leaves(lane.batch)
            slots = [wprog.ensemble_slot_view(lane.batch, i)
                     for i in range(self.slots)]
            if self._stats["rounds"] == 1 and self.pre is None:
                self.pre = before
            kk = min(min(s.remaining, self._plan_for(lane.key).k_steps)
                     for s in lane.slots if s is not None)
            deep = [i for i, s in enumerate(lane.slots)
                    if s is not None and min(s.remaining, 2) > kk]
            self.depth += 1
            super()._round(lane)
            self.depth -= 1
            if self.depth == 0 and deep:     # a round that rolled back
                self.rolled += [_equal(slots[i], wprog.ensemble_slot_view(
                    lane.batch, i)) for i in deep]

        def _try_failover(self, lane, rnd):
            self.at_pivot = _leaves(lane.batch)
            return super()._try_failover(lane, rnd)

    launched = []

    def dying(real):
        def launch(*a, **kw):
            launched.append(1)
            # round 0 is 4 k=2 launches; round 1, the tail, dies after
            # two of its 4 shards launched
            if len(launched) == 7:
                raise InjectedDeviceLoss("lost mid-round", lost_device=2)
            return real(*a, **kw)
        return launch

    for name in ("fused_step_summed", "fused_kstep_summed"):
        monkeypatch.setattr(fused_ops, name, dying(getattr(fused_ops, name)))
    eng = Spy(slots=2, mesh=_mesh((2, 2)), max_round_retries=0)
    s0, s1 = _state(30), _state(31)
    r0 = eng.submit(ForecastRequest(program=KSTEP, state=s0, steps=6))
    r1 = eng.submit(ForecastRequest(program=KSTEP, state=s1, steps=3))
    res = eng.drain()
    assert eng.stats()["mesh_failovers"] == 1
    assert eng.stats()["failovers"][0]["lost_device"] == 2
    assert len(eng.at_pivot) == len(eng.pre)
    assert all(torch.equal(a, b) for a, b in zip(eng.at_pivot, eng.pre))
    assert eng.rolled and all(eng.rolled)
    assert eng.stats()["rolled_back_slot_rounds"] == len(eng.rolled)
    assert res[r0].status == res[r1].status == "ok"
    assert _equal(res[r0].state, _single(KSTEP, s0, 6))
    assert _equal(res[r1].state, _single(KSTEP, s1, 3))


# (writer mesh, reader mesh): None is one device
RESTORES = {"1to4": (None, (2, 2)), "4to1": ((2, 2), None),
            "4to2": ((2, 2), (2, 1))}


@pytest.mark.parametrize("leg", sorted(RESTORES))
def test_elastic_restore_transition_bitwise(tmp_path, leg):
    write, read = RESTORES[leg]
    progs = [StencilProgram(grid_shape=GRID),
             StencilProgram(grid_shape=GRID, op="hdiff")]
    work = [(progs[i % 2], _state(60 + i), 6 + i) for i in range(4)]
    where = lambda shape: ({"device": "cpu"} if shape is None
                           else {"mesh": _mesh(shape)})
    eng = ForecastEngine(slots=2, ckpt_dir=str(tmp_path), **where(write))
    for prog, s, n in work:
        eng.submit(ForecastRequest(program=prog, state=s, steps=n))
    eng.pump()
    eng.pump()
    step = eng.checkpoint()
    assert eng.has_work()
    want = eng.drain()
    back = ForecastEngine.restore(str(tmp_path), step, **where(read))
    assert back.mesh == (None if read is None else _mesh(read))
    got = back.drain()
    assert sorted(got) == sorted(want) == list(range(4))
    for rid, (prog, s, n) in enumerate(work):
        assert got[rid].status == "ok"
        assert _equal(got[rid].state, want[rid].state), rid
        assert _equal(got[rid].state, _single(prog, s, n)), rid


# ---------------------------------------------------------------------------
# Against the JAX engine on a forced four-device mesh (one subprocess)
# ---------------------------------------------------------------------------

_JAX_SIDE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.serve.forecast import ForecastEngine, ForecastRequest
from repro.testing.faults import FaultInjector, FaultSpec
from repro.weather import fields
from repro.weather.program import StencilProgram

cfg = json.loads(sys.argv[1])
kw = ({"axis_types": (jax.sharding.AxisType.Auto,) * 2}
      if hasattr(jax.sharding, "AxisType") else {})
mesh = jax.make_mesh((2, 2), ("data", "model"), **kw)
ins = np.load(cfg["states"])
names = ("u", "v", "t", "pp")

def state(i):
    part = lambda p: {n: jnp.asarray(ins[f"{i}/{p}/{n}"]) for n in names}
    return fields.WeatherState(fields=part("fields"),
                               wcon=jnp.asarray(ins[f"{i}/wcon"]),
                               tens=part("tens"),
                               stage_tens=part("stage_tens"))

arrays, out = {}, {}

def keep(tag, res):
    rec = {}
    for rid, r in res.items():
        rec[str(rid)] = {"status": r.status, "steps_done": r.steps_done,
                         "rounds": r.rounds, "steps": r.steps}
        for p in ("fields", "stage_tens"):
            for n, a in getattr(r.state, p).items():
                arrays[f"{tag}/{rid}/{p}/{n}"] = np.asarray(a)
    return rec

# the scripted fault run
prog = StencilProgram.from_json(cfg["fault_program"])
inj = FaultInjector([FaultSpec(**s) for s in cfg["script"]], seed=cfg["seed"])
eng = ForecastEngine(slots=cfg["fault_slots"], mesh=mesh, fault_injector=inj,
                     max_round_retries=1, retry_backoff_s=0.0)
for i, n in enumerate(cfg["fault_steps"]):
    eng.submit(ForecastRequest(program=prog, state=state(i), steps=n))
res = eng.drain()
st = eng.stats()
out["fault"] = {"results": keep("fault", res), "log": inj.log,
                "stats": {k: st[k] for k in cfg["stat_keys"]},
                "failovers": st["failovers"],
                "mesh_devices": st["mesh_devices"]}

# a checkpoint written on the (2, 2) mesh mid-drain, and the drain
eng = ForecastEngine(slots=2, mesh=mesh, ckpt_dir=cfg["jax_ckpt"])
for i, (p, n) in enumerate(cfg["work"]):
    eng.submit(ForecastRequest(program=StencilProgram.from_json(p),
                               state=state(i), steps=n))
eng.pump()
eng.pump()
out["ckpt_step"] = eng.checkpoint()
out["pins"] = [eng._pinned[k] for k in eng._lanes]
out["jax_drain"] = keep("jax_drain", eng.drain())

# the port's (2, 2) checkpoint, restored on the (2, 2) mesh and drained
eng = ForecastEngine.restore(cfg["port_ckpt"], cfg["port_step"], mesh=mesh)
out["port_ckpt_drain"] = keep("port_ckpt_drain", eng.drain())
np.savez(cfg["out"], **arrays)
print("RESULT " + json.dumps(out))
"""

FAULT_PROGRAM = StencilProgram(grid_shape=GRID, variant="whole_state",
                               k_steps=1)
# a persistent loss of logical device 3 at round 1, then a corruption of
# the idle slot's y-block 1 rows on the (2, 1) mesh it fails over to; the
# requests retire together, so neither engine has a late-scrubbed slot
SCRIPT = [dict(kind="device_loss", round=1, device=3, once=False),
          dict(kind="wire_corrupt", round=2, shard=1)]
FAULT_STEPS = (4, 4)
STAT_KEYS = ("mesh_failovers", "recovery_rounds", "requests_preserved",
             "lane_failures", "fingerprint_divergence", "scrubbed_idle_slots",
             "quarantined", "rounds")
WORK = [(StencilProgram(grid_shape=GRID), 5),
        (StencilProgram(grid_shape=GRID, op="hdiff"), 3),
        (StencilProgram(grid_shape=GRID), 4),
        (StencilProgram(grid_shape=GRID, op="hdiff"), 6)]


def _work_state(i):
    return _state(700 + i)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The port's (2, 2) checkpoint and drain, then the JAX engine's side in
    one subprocess: the scripted fault run, its own (2, 2) checkpoint and
    drain, and the drain of the port's checkpoint."""
    tmp = tmp_path_factory.mktemp("forecast_mesh")
    arrays = {}
    for i in range(len(WORK)):
        s = _work_state(i)
        for part in ("fields", "tens", "stage_tens"):
            for n, t in getattr(s, part).items():
                arrays[f"{i}/{part}/{n}"] = t.numpy()
        arrays[f"{i}/wcon"] = s.wcon.numpy()
    np.savez(tmp / "states.npz", **arrays)
    port_ckpt = tmp / "port_ckpt"
    eng = ForecastEngine(slots=2, mesh=_mesh((2, 2)), ckpt_dir=str(port_ckpt))
    for i, (prog, n) in enumerate(WORK):
        eng.submit(ForecastRequest(program=prog, state=_work_state(i),
                                   steps=n))
    eng.pump()
    eng.pump()
    port_step = eng.checkpoint()
    port_drain = eng.drain()
    cfg = {"states": str(tmp / "states.npz"), "out": str(tmp / "out.npz"),
           "fault_program": FAULT_PROGRAM.to_json(), "script": SCRIPT,
           "seed": 3, "fault_slots": 3, "fault_steps": list(FAULT_STEPS),
           "stat_keys": list(STAT_KEYS), "jax_ckpt": str(tmp / "jax_ckpt"),
           "work": [[p.to_json(), n] for p, n in WORK],
           "port_ckpt": str(port_ckpt), "port_step": port_step}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           # one thread: the suite's other workers share the cores
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1"}
    r = subprocess.run([sys.executable, "-c", _JAX_SIDE, json.dumps(cfg)],
                       env=env, capture_output=True, text=True, timeout=600)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and line, r.stderr[-3000:]
    return (json.loads(line[0][7:]), np.load(tmp / "out.npz"), cfg,
            port_drain)


def _assert_close(tag, arrays, rid, got, prog, steps, state):
    """`got`'s fp32 fields against the JAX side's `tag` result: within TOL,
    plus, for the dycore, `limiter_flip_bound` of the last step's hdiff
    input (f + dt * stage, from the port's single-device run of the steps
    before it) at that input's fragile points."""
    prev = _single(prog, state, steps - 1) if prog.op == "dycore" else None
    for name in prog.fields:
        want = arrays[f"{tag}/{rid}/fields/{name}"]
        bound = 0.0
        if prev is not None:
            stage = torch.from_numpy(arrays[f"{tag}/{rid}/stage_tens/{name}"])
            bound = fused_ref.limiter_flip_bound(
                prev.fields[name] + np.float32(prog.dt) * stage).numpy()
        err = np.abs(got.fields[name].numpy() - want)
        assert (err <= TOL + bound).all(), (tag, rid, name, err.max())


def test_scripted_mesh_fault_run_matches_the_jax_engine(jax_side):
    res_j, arrays, _, _ = jax_side
    want = res_j["fault"]
    inj = FaultInjector([FaultSpec(**s) for s in SCRIPT], seed=3)
    eng = ForecastEngine(slots=3, mesh=_mesh((2, 2)), fault_injector=inj,
                         max_round_retries=1, retry_backoff_s=0.0)
    states = [_work_state(i) for i in range(len(FAULT_STEPS))]
    for s, n in zip(states, FAULT_STEPS):
        eng.submit(ForecastRequest(program=FAULT_PROGRAM, state=s, steps=n))
    res = eng.drain()
    st = eng.stats()
    assert inj.log == want["log"] and len(inj.log) == 3
    assert {k: st[k] for k in STAT_KEYS} == want["stats"]
    assert st["mesh_failovers"] == 1 and st["fingerprint_divergence"] == 1
    assert st["mesh_devices"] == want["mesh_devices"] == [0, 1]
    (fo,), (jfo,) = st["failovers"], want["failovers"]
    for key in ("round", "lost_device", "from_devices", "to_devices",
                "from_shape", "to_shape", "requests_preserved"):
        assert fo[key] == jfo[key], key
    assert sorted(map(str, res)) == sorted(want["results"])
    for rid, r in res.items():
        w = want["results"][str(rid)]
        assert (r.status, r.steps_done, r.rounds) == \
            (w["status"], w["steps_done"], w["rounds"]) == ("ok", 4, 4)
        _assert_close("fault", arrays, rid, r.state, FAULT_PROGRAM,
                      r.steps, states[rid])
        assert _equal(r.state, _single(FAULT_PROGRAM, states[rid], r.steps))


@pytest.mark.parametrize("read", [(2, 2), (4, 1)])
def test_jax_mesh_checkpoint_restores_and_drains_in_the_port(jax_side,
                                                             read):
    res_j, arrays, cfg, _ = jax_side
    eng = ForecastEngine.restore(cfg["jax_ckpt"], res_j["ckpt_step"],
                                 mesh=_mesh(read))
    assert [eng._pinned[k] for k in eng._lanes] == res_j["pins"]
    got = eng.drain()
    want = res_j["jax_drain"]
    assert sorted(map(str, got)) == sorted(want)
    for rid, r in got.items():
        w = want[str(rid)]
        assert (r.status, r.steps_done, r.rounds) == \
            (w["status"], w["steps_done"], w["rounds"])
        prog, steps = WORK[rid]
        _assert_close("jax_drain", arrays, rid, r.state, prog, steps,
                      _work_state(rid))


def test_port_mesh_checkpoint_restores_and_drains_in_jax(jax_side):
    res_j, arrays, _, port_drain = jax_side
    got = res_j["port_ckpt_drain"]
    assert sorted(got) == sorted(map(str, port_drain))
    for rid, w in port_drain.items():
        g = got[str(rid)]
        assert (g["status"], g["steps_done"]) == (w.status, w.steps_done)
        assert w.status == "ok"
        prog, steps = WORK[rid]
        _assert_close("port_ckpt_drain", arrays, rid, w.state, prog, steps,
                      _work_state(rid))
        assert _equal(w.state, _single(prog, _work_state(rid), steps))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guard_kernel_with_offsets_bit_equal_to_plain(dtype, cuda):
    from repro_torch.kernels.slot_guard.slot_guard import (
        slot_guard_blocks_cuda, slot_guard_cuda)
    st = _state(5, dtype, ensemble=4)
    st.fields["u"][1, 0, 3, 5] = float("nan")
    st.tens["t"][2, 1, 12, 9] = 5e6
    leaves = fields.state_leaves(st)
    want_ok, want_fp = guard_ref.slot_guard(leaves, 1e6)
    dev = [t.to(cuda) for t in leaves]
    blocks = [([t[..., y0:y0 + 8, x0:x0 + 8] for t in dev], 0, y0, x0)
              for y0 in (0, 8) for x0 in (0, 8)]
    _build.reset_launches()
    ok, fp = slot_guard_blocks_cuda(blocks, 4, 1e6)
    assert _build.LAUNCHES["slot_guard"] == len(blocks) + 1
    assert ok.tolist() == want_ok.tolist() == [True, False, False, True]
    assert fp.tolist() == want_fp.tolist()
    # the ensemble split: each block holds two slots at its offset
    halves = [([t[e0:e0 + 2] for t in dev], e0, 0, 0) for e0 in (0, 2)]
    assert slot_guard_blocks_cuda(halves, 4, 1e6)[1].tolist() == \
        want_fp.tolist()
    # one partial, at an offset, against the plain words
    cpu = [t[..., 8:, 4:12] for t in leaves]
    thr = guard_ref.threshold(leaves[0].dtype, 1e6)
    plain = guard_ref.guard_finish(guard_ref.guard_words(cpu, 8, 4)[None],
                                   thr)
    got = slot_guard_blocks_cuda([([t[..., 8:, 4:12] for t in dev], 0, 8,
                                   4)], 4, 1e6)
    assert got[1].tolist() == plain[1].tolist()
    assert slot_guard_cuda(dev, 1e6)[1].tolist() == want_fp.tolist()


@pytest.mark.cuda
def test_mesh_kernel_digest_equals_the_single_device_kernel(cuda):
    mesh = _mesh((2, 2), device="cuda:0")
    for dtype in ("float32", "bfloat16"):
        st = _state(6, dtype, ensemble=4)
        sharded = domain.shard_state(st, mesh, (None, None) + AXES)
        _build.reset_launches()
        ok, fp = wprog.slot_guard(sharded, 1e6)
        assert _build.LAUNCHES["slot_guard"] == 5
        whole = wprog.slot_guard(wprog.map_state(st, lambda t: t.to(cuda)),
                                 1e6)
        assert fp.tolist() == whole[1].tolist()
        assert ok.tolist() == whole[0].tolist() == [True] * 4


@pytest.mark.cuda
def test_mesh_drain_on_the_card_bit_equal_to_solo(cuda):
    grid = (8, 32, 32)
    mesh = _mesh((2, 2), device="cuda:0")
    progs = [StencilProgram(grid_shape=grid),
             StencilProgram(grid_shape=grid, dtype="bfloat16"),
             StencilProgram(grid_shape=grid, op="hdiff")]
    eng = ForecastEngine(slots=2, mesh=mesh)
    assert eng.device.type == "cuda"
    reqs = []
    for i, steps in enumerate([3, 2, 5, 1, 4, 3]):
        prog = progs[i % 3]
        st_ = _state(i, prog.dtype, grid=grid)
        reqs.append((eng.submit(ForecastRequest(program=prog, state=st_,
                                                steps=steps)), st_, prog))
    _build.reset_launches()
    res = eng.drain()
    s = eng.stats()
    assert _build.LAUNCHES["slot_guard"] == 5 * s["rounds"]
    assert s["fallback_compiles"] == 0 and s["fingerprint_divergence"] == 0
    for rid, st_, prog in reqs:
        plan = wprog.compile(prog, mesh=mesh)
        want = domain.gather_state(plan.run(
            domain.shard_state(st_, mesh, plan.state_spec), res[rid].steps))
        assert _equal(res[rid].state, want), rid
        # the single-device plan at the lane's round strategy (a k-step
        # round rounds once in bf16 where k launches round k times)
        pin = eng._pinned[plan_cache_key(prog, ensemble=2)]
        single = wprog.compile(dataclasses.replace(prog, **pin),
                               device=cuda).run(
            wprog.map_state(st_, lambda t: t.to(cuda)), res[rid].steps)
        assert _equal(res[rid].state, single), rid
