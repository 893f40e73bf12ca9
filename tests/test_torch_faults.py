"""The port's fault injector and the supervised engine's failure paths.

The single-device cases of the JAX package's `tests/test_faults.py`, run
on the port's `ForecastEngine` on the CPU: the harness itself, the compile
chain (native, then the op's reference plan: the port has no interpreter
stage), transient and persistent device loss, quarantine with a per-leaf
diagnosis, the guard's bounds and its off switch, backpressure, deadlines,
a straggler past the round deadline, wire corruption caught by the
fingerprint, and the engine's checkpoint safety. Parity with the JAX
package: the same `FaultSpec`s and seed poison the same positions, and a
scripted fault run gives the same statuses, steps done, diagnoses and
stats counters in both engines.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.serve.forecast import ForecastEngine as JEngine
from repro.serve.forecast import ForecastRequest as JRequest
from repro.testing.faults import FaultInjector as JInjector
from repro.testing.faults import FaultSpec as JSpec
from repro.weather import fields as jfields
from repro.weather import program as jprog
from repro_torch.ckpt.checkpoint import CheckpointCorruptError
from repro_torch.serve.forecast import (ForecastEngine, ForecastRequest,
                                        QueueFullError)
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultInjector, FaultSpec
from repro_torch.weather import convert, fields
from repro_torch.weather import program as wprog
from repro_torch.weather.program import StencilProgram

GRID = (3, 8, 8)
PROG = StencilProgram(grid_shape=GRID)


def _state(seed, grid=GRID, dtype="float32", ensemble=1):
    return fields.initial_state(torch.Generator().manual_seed(seed), grid,
                                ensemble=ensemble, dtype=dtype, device="cpu")


def _engine(**kw):
    return ForecastEngine(device="cpu", **kw)


def _solo(prog, state, steps):
    return wprog.compile(prog, device="cpu").run(state, steps)


def _assert_bits(result, state, prog=None):
    want = _solo(prog or result.program, state, result.steps)
    for i, (got, w) in enumerate(zip(wprog.state_leaves(result.state),
                                     wprog.state_leaves(want), strict=True)):
        assert torch.equal(got, w), i


def _to_port(js):
    d = lambda m: {k: np.asarray(v) for k, v in m.items()}
    return convert.state_from_numpy(d(js.fields), np.asarray(js.wcon),
                                    d(js.tens), d(js.stage_tens),
                                    device="cpu")


# ---------------------------------------------------------------------------
# The harness itself
# ---------------------------------------------------------------------------


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultSpec(kind="meteor_strike")
    with pytest.raises(ValueError, match="device="):
        FaultSpec(kind="poison_nan", device=1)


def test_injector_poison_is_deterministic_and_in_place():
    def poisoned():
        batch = _state(0, ensemble=3)
        keep = {n: t.clone() for n, t in batch.fields.items()}
        inj = FaultInjector([FaultSpec(kind="poison_nan", round=0)], seed=9)
        out = inj.poison(batch, "dycore", 0, (0, 1, 2))
        assert out is batch
        return batch.fields["u"].clone(), inj.log[0]["slot"], keep

    a, slot_a, keep = poisoned()
    b, slot_b, _ = poisoned()
    assert slot_a == slot_b
    assert torch.equal(a.isnan(), b.isnan())
    assert a[slot_a].isnan().any()
    for s in range(3):
        if s != slot_a:
            assert torch.equal(a[s], keep["u"][s])


def test_injector_once_retires_spec():
    inj = FaultInjector([FaultSpec(kind="device_loss", round=1)])
    inj.on_round("dycore", 0)
    with pytest.raises(faults.InjectedDeviceLoss):
        inj.on_round("dycore", 1)
    inj.on_round("dycore", 1)
    assert inj.fired("device_loss") == 1


def test_per_device_loss_never_fires_without_a_mesh():
    inj = FaultInjector([FaultSpec(kind="device_loss", round=0, device=0,
                                   once=False)])
    for rnd in range(3):
        inj.on_round("dycore", rnd, device_ids=None)
    assert inj.fired() == 0
    eng = _engine(slots=1, fault_injector=inj)
    s = _state(1)
    rid = eng.submit(ForecastRequest(program=PROG, state=s, steps=2))
    r = eng.drain()[rid]
    assert r.status == "ok" and eng.stats()["round_retries"] == 0


@pytest.mark.parametrize("kind,field", [("poison_nan", None),
                                        ("poison_inf", "v"),
                                        ("wire_corrupt", None),
                                        ("wire_corrupt", "t")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_same_spec_and_seed_poison_the_same_positions_as_jax(kind, field,
                                                             dtype):
    js = jfields.initial_state(jax.random.PRNGKey(4), GRID, ensemble=3,
                               dtype=jnp.dtype(dtype))
    port = _to_port(js)
    spec = dict(kind=kind, round=2, field=field)
    jout = JInjector([JSpec(**spec)], seed=11).poison(
        js, "dycore", 2, (0, 2), nonparticipants=(1,))
    inj = FaultInjector([FaultSpec(**spec)], seed=11)
    inj.poison(port, "dycore", 2, (0, 2), nonparticipants=(1,))
    got = convert.state_to_numpy(port)
    for part, i in (("fields", 0), ("tens", 2), ("stage_tens", 3)):
        for n, a in got[i].items():
            w = np.asarray(getattr(jout, part)[n])
            np.testing.assert_array_equal(a, w.view(a.dtype), err_msg=n)
    np.testing.assert_array_equal(
        got[1], np.asarray(jout.wcon).view(got[1].dtype))


# ---------------------------------------------------------------------------
# Compile fallback chain
# ---------------------------------------------------------------------------


def _fail(stages):
    def hook(prog, stage):
        if stage in stages:
            raise faults.InjectedCompileError(stage)
    return hook


def test_compile_with_fallback_stages():
    plan, fb, errors = wprog.compile_with_fallback(PROG, device="cpu")
    assert fb is None and errors == [] and plan.variant == "whole_state"
    plan, fb, errors = wprog.compile_with_fallback(
        PROG, device="cpu", attempt_hook=_fail({"native"}))
    assert fb == "reference"
    assert plan.variant == "unfused" and plan.k_steps == 1
    assert plan.pallas_calls_per_round == 0
    assert [s for s, _ in errors] == ["native"]
    with pytest.raises(RuntimeError, match="exhausted"):
        wprog.compile_with_fallback(
            PROG, device="cpu",
            attempt_hook=_fail({"native", "reference"}))


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_compile_with_fallback_degrades_on_the_card_only_when_injected(
        monkeypatch, device):
    """On the card a real failure to compile the kernelled plan propagates
    as itself (no kernel is replaced by the plain ops unannounced), and an
    injected one still reaches the reference plan; on the CPU any failure
    degrades, as in the JAX package. `compile` is stubbed, so this holds
    with or without a card."""
    calls = []

    def fake_compile(prog, mesh=None, *, device):
        calls.append(prog.variant)
        if prog.variant != "unfused":
            raise ValueError("planner refused")
        return "reference plan"

    monkeypatch.setattr(wprog, "compile", fake_compile)
    if device == "cuda":
        with pytest.raises(ValueError, match="planner refused"):
            wprog.compile_with_fallback(PROG, device=device)
        assert calls == ["auto"]
    else:
        plan, fb, errors = wprog.compile_with_fallback(PROG, device=device)
        assert (plan, fb) == ("reference plan", "reference")
        assert [s for s, _ in errors] == ["native"]
    calls.clear()
    plan, fb, errors = wprog.compile_with_fallback(
        PROG, device=device, attempt_hook=_fail({"native"}))
    assert (plan, fb, calls) == ("reference plan", "reference", ["unfused"])
    assert [s for s, _ in errors] == ["native"]


def test_reference_program_is_conservative():
    prog = StencilProgram(grid_shape=GRID, variant="kstep", k_steps=2,
                          exchange_dtype="bfloat16")
    ref = wprog.reference_program(prog)
    assert ref.variant == "unfused" and ref.k_steps == 1
    assert ref.exchange_dtype is None
    wprog.compile(ref, device="cpu")


def test_engine_forced_lowering_fallback_is_counted():
    """An injected native-compile failure degrades to the reference plan
    (the op's unfused variant: the plain ops, no kernel): counted in
    stats(), and each result is bit-equal to a solo run of that plan."""
    inj = FaultInjector([FaultSpec(kind="compile_fail", op="dycore",
                                   attempt="native")])
    eng = _engine(slots=2, fault_injector=inj)
    sts = [_state(40 + i) for i in range(3)]
    rids = [eng.submit(ForecastRequest(program=PROG, state=s, steps=2))
            for s in sts]
    res = eng.drain()
    s = eng.stats()
    assert s["fallback_compiles"] == 1
    assert s["plan_fallbacks"] == {"dycore": "reference"}
    assert inj.fired("compile_fail") == 1
    ref = wprog.reference_program(PROG)
    for rid, st_ in zip(rids, sts):
        assert res[rid].status == "ok"
        _assert_bits(res[rid], st_, prog=ref)


# ---------------------------------------------------------------------------
# Device loss, stragglers
# ---------------------------------------------------------------------------


def test_transient_device_loss_retries_and_serves():
    inj = FaultInjector([FaultSpec(kind="device_loss", round=1)])
    eng = _engine(slots=2, retry_backoff_s=0.0, fault_injector=inj)
    sts = [_state(50 + i) for i in range(2)]
    rids = [eng.submit(ForecastRequest(program=PROG, state=s, steps=3))
            for s in sts]
    res = eng.drain()
    assert eng.stats()["round_retries"] == 1
    assert eng.stats()["lane_failures"] == 0
    for rid, s in zip(rids, sts):
        assert res[rid].status == "ok"
        _assert_bits(res[rid], s)


def test_persistent_device_loss_fails_lane_not_engine():
    inj = FaultInjector([FaultSpec(kind="device_loss", round=1, once=False)])
    eng = _engine(slots=2, max_round_retries=1, retry_backoff_s=0.0,
                  fault_injector=inj)
    sts = [_state(60 + i) for i in range(2)]
    rids = [eng.submit(ForecastRequest(program=PROG, state=s, steps=3))
            for s in sts]
    res = eng.drain()
    assert not eng.has_work()
    assert eng.stats()["lane_failures"] == 1
    for rid in rids:
        assert res[rid].status == "failed"
        assert res[rid].diagnosis["reason"] == "round_failure"
        assert "InjectedDeviceLoss" in res[rid].diagnosis["error"]
        assert res[rid].steps_done == 1
    inj.specs.clear()
    s = _state(70)
    rid = eng.submit(ForecastRequest(program=PROG, state=s, steps=2))
    r = eng.drain()[rid]
    assert r.status == "ok"
    _assert_bits(r, s)


def test_straggler_past_the_round_deadline_retries():
    inj = FaultInjector([FaultSpec(kind="straggler", round=1,
                                   delay_s=0.3)])
    eng = _engine(slots=1, retry_backoff_s=0.0, round_deadline_s=0.2,
                  fault_injector=inj)
    s = _state(71)
    rid = eng.submit(ForecastRequest(program=PROG, state=s, steps=3))
    r = eng.drain()[rid]
    st_ = eng.stats()
    assert st_["round_deadline_hits"] == 1 and st_["round_retries"] == 1
    assert r.status == "ok"
    _assert_bits(r, s)


# ---------------------------------------------------------------------------
# Guard, quarantine, fingerprint
# ---------------------------------------------------------------------------


def test_poisoned_field_diagnosis_names_the_leaf():
    inj = FaultInjector([FaultSpec(kind="poison_inf", round=0, slot=0,
                                   field="u")])
    eng = _engine(slots=1, fault_injector=inj)
    rid = eng.submit(ForecastRequest(program=PROG, state=_state(80),
                                     steps=4))
    r = eng.drain()[rid]
    assert r.status == "failed"
    d = r.diagnosis
    assert d["reason"] == "validity_guard"
    assert set(d["bad_leaves"]) == {"fields/u"}
    assert d["bad_leaves"]["fields/u"]["inf"] > 0
    assert d["first_bad"] == "fields/u"
    assert r.steps_done < r.steps
    assert eng.stats()["quarantined"] == 1


def test_guard_bounds_catch_nonfinite_free_blowup():
    eng = _engine(slots=1, guard_limit=10.0)
    s = _state(81)
    big = wprog.map_state(s, lambda a: a * 1e3)
    rid = eng.submit(ForecastRequest(program=PROG, state=big, steps=2))
    r = eng.drain()[rid]
    assert r.status == "failed"
    assert r.diagnosis["reason"] == "validity_guard"
    assert any(v["out_of_bounds"] > 0
               for v in r.diagnosis["bad_leaves"].values())


def test_guard_off_returns_poison_as_ok():
    inj = FaultInjector([FaultSpec(kind="poison_nan", round=0, slot=0)])
    eng = _engine(slots=1, guard=False, fault_injector=inj)
    rid = eng.submit(ForecastRequest(program=PROG, state=_state(82),
                                     steps=2))
    r = eng.drain()[rid]
    assert r.status == "ok"
    assert any(t.isnan().any() for t in wprog.state_leaves(r.state))


def test_wire_corruption_is_caught_by_the_fingerprint():
    """Finite, in-bounds damage passes the validity check: on an idle slot
    the fingerprint scrubs it, on a rolled-back in-flight slot it
    quarantines the request."""
    eng = _engine(slots=2, fault_injector=FaultInjector(
        [FaultSpec(kind="wire_corrupt", round=1, slot=1)]))
    s = _state(83)
    rid = eng.submit(ForecastRequest(program=PROG, state=s, steps=3))
    r = eng.drain()[rid]
    assert r.status == "ok"
    _assert_bits(r, s)
    st_ = eng.stats()
    assert st_["fingerprint_divergence"] == 1
    assert st_["scrubbed_idle_slots"] == 1

    prog = StencilProgram(grid_shape=GRID, variant="kstep", k_steps=2)
    eng = _engine(slots=2, fault_injector=FaultInjector(
        [FaultSpec(kind="wire_corrupt", round=1)]))
    # round 1 runs the 3-step request's tail: the other sits it out
    rids = [eng.submit(ForecastRequest(program=prog, state=_state(84 + i),
                                       steps=steps))
            for i, steps in enumerate([3, 4])]
    res = eng.drain()
    assert res[rids[0]].status == "ok"
    assert res[rids[1]].status == "failed"
    assert res[rids[1]].diagnosis["reason"] == "fingerprint_divergence"
    assert eng.stats()["quarantined"] == 1


# ---------------------------------------------------------------------------
# Backpressure + deadlines
# ---------------------------------------------------------------------------


def test_bounded_queue_backpressure():
    eng = _engine(slots=1, max_queue=2)
    for i in range(2):
        eng.submit(ForecastRequest(program=PROG, state=_state(90 + i),
                                   steps=1))
    with pytest.raises(QueueFullError, match="queue is full"):
        eng.submit(ForecastRequest(program=PROG, state=_state(93), steps=1))
    assert eng.stats()["rejected"] == 1
    eng.drain()
    eng.submit(ForecastRequest(program=PROG, state=_state(94), steps=1))
    with pytest.raises(ValueError, match="max_queue"):
        _engine(slots=1, max_queue=0)


def test_deadline_expires_queued_and_in_flight():
    eng = _engine(slots=1)
    s0, s1 = _state(95), _state(96)
    r0 = eng.submit(ForecastRequest(program=PROG, state=s0, steps=1000,
                                    deadline_s=0.2))
    r1 = eng.submit(ForecastRequest(program=PROG, state=s1, steps=1,
                                    deadline_s=1e-6))
    eng.pump()
    time.sleep(0.25)
    res = eng.drain()
    assert res[r0].status == "expired"
    assert res[r0].diagnosis["where"] == "in_flight"
    assert 0 < res[r0].steps_done < res[r0].steps
    assert res[r1].status == "expired"
    assert res[r1].diagnosis["where"] == "queue"
    assert eng.stats()["deadline_expired"] == 2
    with pytest.raises(ValueError, match="deadline_s"):
        ForecastRequest(program=PROG, state=s0, steps=1,
                        deadline_s=-1.0).validate()


# ---------------------------------------------------------------------------
# Engine checkpoint safety
# ---------------------------------------------------------------------------


def test_corrupt_engine_checkpoint_fails_loud(tmp_path):
    d = str(tmp_path)
    eng = _engine(slots=1, ckpt_dir=d)
    eng.submit(ForecastRequest(program=PROG, state=_state(97), steps=3))
    eng.pump()
    step = eng.checkpoint()
    faults.corrupt_checkpoint(d, step, "bitflip", seed=5)
    with pytest.raises(CheckpointCorruptError):
        ForecastEngine.restore(d, step, device="cpu")


def test_restore_pins_round_strategy(tmp_path):
    d = str(tmp_path)
    eng = _engine(slots=1, ckpt_dir=d)
    s = _state(98)
    rid = eng.submit(ForecastRequest(program=PROG, state=s, steps=3))
    eng.pump()
    step = eng.checkpoint()
    meta = json.load(open(os.path.join(d, f"step_{step:08d}", "meta.json")))
    assert meta["extra"]["mesh_devices"] is None
    pin = meta["extra"]["lanes"][0]["plan"]
    assert pin == {"variant": "whole_state", "k_steps": 1}
    eng2 = ForecastEngine.restore(d, step, device="cpu")
    assert eng2._pinned[next(iter(eng2._lanes))] == pin
    r = eng2.drain()[rid]
    assert r.status == "ok"
    _assert_bits(r, s)


def test_restore_latest_falls_back_past_corrupt_newest(tmp_path):
    d = str(tmp_path)
    eng = _engine(slots=1, ckpt_dir=d)
    s = _state(101)
    rid = eng.submit(ForecastRequest(program=PROG, state=s, steps=4))
    eng.pump()
    step_a = eng.checkpoint()
    eng.pump()
    step_b = eng.checkpoint()
    assert step_b > step_a
    faults.corrupt_checkpoint(d, step_b, "bitflip", seed=5)
    r = ForecastEngine.restore(d, device="cpu").drain()[rid]
    assert r.status == "ok"
    _assert_bits(r, s)
    faults.corrupt_checkpoint(d, step_a, "truncate")
    with pytest.raises(CheckpointCorruptError, match="every checkpoint"):
        ForecastEngine.restore(d, device="cpu")
    with pytest.raises(FileNotFoundError):
        ForecastEngine.restore(str(tmp_path / "none"), device="cpu")


def test_restore_incompatible_engine_sidecar_is_actionable(tmp_path):
    d = str(tmp_path)
    eng = _engine(slots=1, ckpt_dir=d)
    eng.submit(ForecastRequest(program=PROG, state=_state(102), steps=2))
    eng.pump()
    step = eng.checkpoint()
    meta_path = os.path.join(d, f"step_{step:08d}", "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["extra"]["slots"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(CheckpointCorruptError, match="sidecar"):
        ForecastEngine.restore(d, step, device="cpu")


def test_restore_preserves_supervision_config(tmp_path):
    d = str(tmp_path)
    eng = _engine(slots=1, ckpt_dir=d, max_queue=7, guard_limit=123.0,
                  ckpt_every_rounds=5, max_round_retries=4,
                  retry_backoff_s=0.01)
    eng.submit(ForecastRequest(program=PROG, state=_state(99), steps=2))
    eng.pump()
    step = eng.checkpoint()
    eng2 = ForecastEngine.restore(d, step, device="cpu")
    assert eng2.max_queue == 7 and eng2.guard_limit == 123.0
    assert eng2.ckpt_every_rounds == 5 and eng2.max_round_retries == 4
    assert eng2.retry_backoff_s == 0.01 and eng2.guard
    assert all(r.status == "ok" for r in eng2.drain().values())


# ---------------------------------------------------------------------------
# A scripted fault run in both engines
# ---------------------------------------------------------------------------

SCRIPT = [dict(kind="poison_nan", round=1),
          dict(kind="device_loss", round=2),
          dict(kind="poison_inf", round=3, slot=0, field="v")]
STEPS = [3, 2, 4, 2, 3]


@pytest.fixture(scope="module")
def scripted_runs():
    jinj = JInjector([JSpec(**s) for s in SCRIPT], seed=3)
    jeng = JEngine(slots=2, retry_backoff_s=0.0, fault_injector=jinj)
    inj = FaultInjector([FaultSpec(**s) for s in SCRIPT], seed=3)
    eng = _engine(slots=2, retry_backoff_s=0.0, fault_injector=inj)
    jprog_ = jprog.StencilProgram(grid_shape=GRID)
    for i, steps in enumerate(STEPS):
        js = jfields.initial_state(jax.random.PRNGKey(500 + i), GRID)
        jeng.submit(JRequest(program=jprog_, state=js, steps=steps))
        eng.submit(ForecastRequest(program=PROG, state=_to_port(js),
                                   steps=steps))
    return (jeng, jeng.drain(), jinj), (eng, eng.drain(), inj)


def test_scripted_fault_run_matches_the_jax_engine(scripted_runs):
    (jeng, jres, jinj), (eng, res, inj) = scripted_runs
    assert jinj.log == inj.log and len(inj.log) == 3
    assert sorted(res) == sorted(jres)
    for rid, w in jres.items():
        g = res[rid]
        assert (g.status, g.steps_done, g.rounds) == \
            (w.status, w.steps_done, w.rounds), rid
        if w.diagnosis is not None:
            assert g.diagnosis == w.diagnosis, rid
    assert sum(r.status == "failed" for r in res.values()) == 2
    js, s = jeng.stats(), eng.stats()
    # the one designed difference: the JAX engine scrubs a retired slot a
    # round late as a divergence; the port zeroes it as it retires
    assert s["fingerprint_divergence"] == s["scrubbed_idle_slots"] == 0
    assert js["fingerprint_divergence"] == js["scrubbed_idle_slots"]
    skip = {"fingerprint_divergence", "scrubbed_idle_slots",
            "plan_fallbacks", "failovers", "mesh_devices"}
    assert {k: v for k, v in s.items() if k not in skip} == \
        {k: v for k, v in js.items() if k not in skip}
    assert s["plan_fallbacks"] == js["plan_fallbacks"] == {}
    assert s["failovers"] == js["failovers"] == []
    assert s["mesh_devices"] is js["mesh_devices"] is None


def test_scripted_fault_run_healthy_results_match_solo(scripted_runs):
    (_, jres, _), (_, res, _) = scripted_runs
    for rid, r in res.items():
        if r.status == "ok":
            js = jfields.initial_state(jax.random.PRNGKey(500 + rid), GRID)
            _assert_bits(r, _to_port(js))
