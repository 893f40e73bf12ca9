"""The port's forecast service and its slot helpers against the JAX package.

The slot guard returns the JAX package's `ok` and uint32 digest exactly, in
fp32 and bf16, on clean, NaN, Inf, out-of-bounds and -0.0 inputs (and with
the magnitude compared in the leaf's dtype); the slot view / assign /
select match the JAX package's and keep a lane's field-stacked layout;
`reference_program` gives the JAX package's JSON. The port's
`ForecastEngine` (on the CPU here) keeps its contract within itself:
every served result bit-equal to its solo `compile(program).run` (a
hypothesis property over grids, ops, dtypes, step counts and a pinned k=2
program), the ragged pinned-k rollback, validation and zero steps,
exactly M compiles for M programs, per-request latency, checkpoint-restart
and a crash restore at every round boundary equal to an uninterrupted run.
Engine checkpoints cross between the packages: one the JAX engine wrote
mid-drain restores in the port and drains to the JAX package's results
within the main path's tolerance, and the reverse. The `cuda` cases hold
the guard kernel bit-equal to its plain version and a drain on the card
bit-equal to solo runs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.serve.forecast import ForecastEngine as JEngine
from repro.serve.forecast import ForecastRequest as JRequest
from repro.weather import fields as jfields
from repro.weather import program as jprog
from repro_torch.kernels import _build
from repro_torch.kernels.dycore_fused import ref as fused_ref
from repro_torch.kernels.slot_guard import ref as guard_ref
from repro_torch.kernels.slot_guard.slot_guard import slot_guard_cuda
from repro_torch.serve.forecast import (ForecastEngine, ForecastRequest,
                                        ForecastResult)
from repro_torch.weather import convert, dycore, fields
from repro_torch.weather import program as wprog
from repro_torch.weather.program import StencilProgram, plan_cache_key

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                              # pragma: no cover
    HAVE_HYPOTHESIS = False

GRID = (3, 8, 8)
_GRIDS = ((3, 8, 8), (4, 12, 16))
_OPS = ("dycore", "hdiff", "vadvc")
_DTYPES = ("float32", "bfloat16")
TOL = 1e-5      # the main path's fp32 tolerance (tests/test_kernels_*.py)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _np(a):
    return np.asarray(a)


def _to_port(js, device="cpu"):
    d = lambda m: {k: _np(v) for k, v in m.items()}
    return convert.state_from_numpy(d(js.fields), _np(js.wcon), d(js.tens),
                                    d(js.stage_tens), device=device)


def _bits(t):
    return convert.tensor_to_numpy(t).view(
        np.uint16 if t.element_size() == 2 else np.uint32)


def _state(seed, grid=GRID, dtype="float32", ensemble=1, device="cpu"):
    return fields.initial_state(torch.Generator().manual_seed(seed), grid,
                                ensemble=ensemble, dtype=dtype,
                                device=device)


# ---------------------------------------------------------------------------
# The slot guard against the JAX package's
# ---------------------------------------------------------------------------


def _guard_case(case, dtype):
    js = jfields.initial_state(jax.random.PRNGKey(7), GRID, ensemble=3,
                               dtype=jnp.dtype(dtype))
    f, t, s = dict(js.fields), dict(js.tens), dict(js.stage_tens)
    w = js.wcon
    if case == "nan":
        f["u"] = f["u"].at[1, 0, 0, 0].set(jnp.nan)
    elif case == "inf":
        w = w.at[2, 1, 2, 3].set(-jnp.inf)
    elif case == "oob":
        t["t"] = t["t"].at[0, 2, 7, 7].set(5e6)
    elif case == "negzero":
        s["pp"] = s["pp"].at[1, 1, 2, 3].set(-0.0)   # over a +0.0
    return jfields.WeatherState(fields=f, wcon=w, tens=t, stage_tens=s)


@pytest.mark.parametrize("case", ["clean", "nan", "inf", "oob", "negzero"])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_slot_guard_matches_jax_exactly(case, dtype):
    js = _guard_case(case, dtype)
    want_ok, want_fp = jprog.slot_guard(js, 1e6)
    ok, fp = wprog.slot_guard(_to_port(js), 1e6)
    assert ok.dtype == torch.bool and fp.dtype == torch.int64
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(fp.numpy(),
                                  np.asarray(want_fp).astype(np.int64))
    assert wprog.slot_validity(_to_port(js), 1e6).tolist() == \
        np.asarray(jprog.slot_validity(js, 1e6)).tolist()
    if case == "negzero":     # -0.0 is other bits: the digest sees it
        clean = wprog.slot_guard(_to_port(_guard_case("clean", dtype)),
                                 1e6)[1]
        assert fp[1] != clean[1] and fp[0] == clean[0]


@pytest.mark.parametrize("dtype,limit,value", [
    ("bfloat16", 999.9, 1000.0),    # the limit rounds to 1000 in bf16: ok
    ("bfloat16", 1000.1, 1000.0),
    ("bfloat16", 995.0, 1000.0),    # rounds to 996: not ok
    ("float32", 999.9, 1000.0),
    ("float32", 1000.0, 1000.0),
    ("float32", -0.0, 0.0),
    ("float32", float("inf"), 3.0)])
def test_slot_guard_compares_in_the_leaf_dtype(dtype, limit, value):
    js = jfields.zeros_state(GRID, ensemble=2, dtype=jnp.dtype(dtype))
    js.fields["u"] = js.fields["u"].at[0, 1, 2, 3].set(value)
    want_ok, want_fp = jprog.slot_guard(js, limit)
    ok, fp = wprog.slot_guard(_to_port(js), limit)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(fp.numpy(),
                                  np.asarray(want_fp).astype(np.int64))


def test_slot_guard_threshold_bits():
    from repro_torch.kernels.slot_guard.slot_guard import threshold
    assert threshold(torch.float32, 1e6) == 0x49742400
    assert threshold(torch.bfloat16, 999.9) == 0x447A
    assert threshold(torch.float32, float("inf")) == 0x7F7FFFFF
    assert threshold(torch.float32, -0.0) == 0
    assert threshold(torch.float32, -1.0) == -1
    assert threshold(torch.float32, float("nan")) == -1


# ---------------------------------------------------------------------------
# The slot helpers against the JAX package's, in place
# ---------------------------------------------------------------------------


def _same(port_state, js):
    a = convert.state_to_numpy(port_state)
    for name in js.fields:
        np.testing.assert_array_equal(a[0][name].view(np.uint32),
                                      _np(js.fields[name]).view(np.uint32))
        np.testing.assert_array_equal(
            a[3][name].view(np.uint32),
            _np(js.stage_tens[name]).view(np.uint32))
        np.testing.assert_array_equal(a[2][name].view(np.uint32),
                                      _np(js.tens[name]).view(np.uint32))
    np.testing.assert_array_equal(a[1].view(np.uint32),
                                  _np(js.wcon).view(np.uint32))


def _stacked(state):
    return all(dycore._stacked_base(list(getattr(state, p).values()))
               is not None for p in ("fields", "tens", "stage_tens"))


def test_slot_view_assign_select_match_jax_in_place():
    jb = jfields.initial_state(jax.random.PRNGKey(0), GRID, ensemble=3)
    jsub = jfields.initial_state(jax.random.PRNGKey(1), GRID, ensemble=2)
    jold = jfields.initial_state(jax.random.PRNGKey(2), GRID, ensemble=3)
    b, sub, old = _to_port(jb), _to_port(jsub), _to_port(jold)
    _same(wprog.ensemble_slot_view(b, 1), jprog.ensemble_slot_view(jb, 1))
    assert _stacked(wprog.ensemble_slot_view(b, 1))
    base = dycore._stacked_base(list(b.fields.values()))
    ptr = base.data_ptr()
    got = wprog.ensemble_slot_assign(b, [2, 0], sub)
    jgot = jprog.ensemble_slot_assign(jb, [2, 0], jsub)
    assert got is b and _stacked(b)
    assert dycore._stacked_base(list(b.fields.values())).data_ptr() == ptr
    _same(b, jgot)
    mask = np.array([True, False, True])
    sel = wprog.ensemble_slot_select(mask, b, old)
    assert sel is b and _stacked(b)
    _same(b, jprog.ensemble_slot_select(mask, jgot, jold))
    # shared tensors (what a round did not write) are left alone
    b2 = fields.WeatherState(fields=b.fields, wcon=old.wcon, tens=old.tens,
                             stage_tens=b.stage_tens)
    wprog.ensemble_slot_select(np.array([False] * 3), b2, old)


def test_admit_and_scrub_write_into_the_stacked_lane():
    """A lane is allocated field-stacked; admission and the scrub write
    into its storage by index, so the layout (and the storage) stays."""
    prog = StencilProgram(grid_shape=GRID)
    eng = ForecastEngine(slots=3, device="cpu")
    for i in range(2):
        eng.submit(ForecastRequest(program=prog, state=_state(i), steps=2))
    eng._admit()
    lane = next(iter(eng._lanes.values()))
    ptrs = [dycore._stacked_base(list(getattr(lane.batch, p).values()))
            .data_ptr() for p in ("fields", "tens", "stage_tens")]
    assert _stacked(lane.batch)
    eng._scrub(lane, 1)
    assert _stacked(lane.batch)
    assert ptrs == [dycore._stacked_base(
        list(getattr(lane.batch, p).values())).data_ptr()
        for p in ("fields", "tens", "stage_tens")]
    assert not lane.batch.wcon[1].any() and lane.batch.wcon[0].any()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(variant="kstep", k_steps=2, exchange_dtype="bfloat16"),
    dict(op="hdiff", variant="kstep", k_steps=3),
    dict(op="vadvc", dtype="bfloat16"),
    dict(op="hadv_upwind"),
    dict(op="asselin"),
    dict(op="vadvc_update", variant="whole_state")])
def test_reference_program_json_matches_jax(kw):
    want = jprog.reference_program(jprog.StencilProgram(grid_shape=GRID,
                                                        **kw))
    got = wprog.reference_program(StencilProgram(grid_shape=GRID, **kw))
    assert got.to_json() == want.to_json()
    wprog.compile(got, device="cpu")


# ---------------------------------------------------------------------------
# The engine's contract within the port (on the CPU)
# ---------------------------------------------------------------------------

_SOLO_PLANS = {}


def _solo_plan(prog):
    plan = _SOLO_PLANS.get(prog)
    if plan is None:
        plan = _SOLO_PLANS.setdefault(prog,
                                      wprog.compile(prog, device="cpu"))
    return plan


def _mk_request(seed, grid_i, op_i, dtype_i, steps, pinned_k=False):
    grid = _GRIDS[grid_i % len(_GRIDS)]
    op = _OPS[op_i % len(_OPS)]
    dtype = _DTYPES[dtype_i % len(_DTYPES)]
    kw = {"variant": "kstep", "k_steps": 2} if pinned_k and op == "dycore" \
        else {}
    prog = StencilProgram(grid_shape=grid, op=op, dtype=dtype, **kw)
    return ForecastRequest(program=prog, state=_state(seed, grid, dtype),
                           steps=steps)


def _assert_bit_identical(result: ForecastResult, request_state):
    want = _solo_plan(result.program).run(request_state, result.steps)
    assert result.state.wcon.device.type == "cpu"
    got_l, want_l = wprog.state_leaves(result.state), wprog.state_leaves(want)
    assert len(got_l) == len(want_l)
    for i, (got, w) in enumerate(zip(got_l, want_l)):
        np.testing.assert_array_equal(
            _bits(got), _bits(w),
            err_msg=f"leaf {i} steps={result.steps} op={result.program.op}")


_ENGINE = ForecastEngine(slots=2, device="cpu")


def _check_mix(mix):
    reqs = []
    for seed, (grid_i, op_i, dtype_i, steps, pinned) in enumerate(mix):
        req = _mk_request(seed, grid_i, op_i, dtype_i, steps, pinned)
        state = req.state
        reqs.append((_ENGINE.submit(req), state))
    results = _ENGINE.drain()
    for rid, state in reqs:
        assert results[rid].status == "ok"
        _assert_bit_identical(results[rid], state)


if HAVE_HYPOTHESIS:
    @settings(max_examples=8, deadline=None, derandomize=True)
    @given(st.lists(st.tuples(st.integers(0, 1), st.integers(0, 2),
                              st.integers(0, 1), st.integers(0, 4),
                              st.booleans()), min_size=2, max_size=5))
    def test_batching_invariance_property(mix):
        _check_mix(mix)
else:                                            # pragma: no cover
    def test_batching_invariance_property():
        rng = np.random.default_rng(0)
        for _ in range(4):
            n = int(rng.integers(2, 6))
            _check_mix([(int(rng.integers(0, 2)), int(rng.integers(0, 3)),
                         int(rng.integers(0, 2)), int(rng.integers(0, 5)),
                         bool(rng.integers(0, 2))) for _ in range(n)])


def test_fault_free_drains_scrub_nothing():
    """Idle slots hold zeros (a retiring slot is zeroed), a fixed point of
    every op: across the property run no digest diverged and nothing was
    scrubbed."""
    _check_mix([(0, 0, 0, 4, False), (1, 1, 1, 1, False),
                (0, 0, 0, 2, True), (1, 2, 0, 3, False)])
    s = _ENGINE.stats()
    assert s["fingerprint_divergence"] == 0 and s["scrubbed_idle_slots"] == 0
    assert s["fallback_compiles"] == 0 and s["plan_fallbacks"] == {}


def test_retiring_slot_is_zeroed_where_jax_scrubs_it_a_round_late():
    """A design difference: the JAX engine leaves a retired slot's state
    to step along idle, and its next fingerprint check counts that as a
    divergence and scrubs it; the port zeroes the slot as it retires. The
    results are the same."""
    jprog_ = jprog.StencilProgram(grid_shape=GRID)
    jeng = JEngine(slots=3)
    eng = ForecastEngine(slots=3, device="cpu")
    for i, steps in enumerate([1, 3]):
        js = jfields.initial_state(jax.random.PRNGKey(i), GRID)
        jeng.submit(JRequest(program=jprog_, state=js, steps=steps))
        eng.submit(ForecastRequest(program=StencilProgram(grid_shape=GRID),
                                   state=_to_port(js), steps=steps))
    jres, res = jeng.drain(), eng.drain()
    js_, s = jeng.stats(), eng.stats()
    assert js_["fingerprint_divergence"] == js_["scrubbed_idle_slots"] == 1
    assert s["fingerprint_divergence"] == s["scrubbed_idle_slots"] == 0
    assert [r.status for r in res.values()] == \
        [r.status for r in jres.values()] == ["ok", "ok"]


def test_ragged_pinned_k_rollback_bit_identical():
    prog = StencilProgram(grid_shape=GRID, variant="kstep", k_steps=2)
    eng = ForecastEngine(slots=3, device="cpu")
    reqs = []
    for i, steps in enumerate([7, 10, 3, 4, 1]):
        st_ = _state(10 + i)
        reqs.append((eng.submit(ForecastRequest(program=prog, state=st_,
                                                steps=steps)), st_))
    results = eng.drain()
    for rid, st_ in reqs:
        _assert_bit_identical(results[rid], st_)
    s = eng.stats()
    assert s["rolled_back_slot_rounds"] > 0
    assert s["fingerprint_divergence"] == 0 and s["scrubbed_idle_slots"] == 0


def test_request_validation_and_zero_steps():
    st_ = _state(0)
    prog = StencilProgram(grid_shape=GRID)
    with pytest.raises(ValueError, match="ensemble"):
        ForecastRequest(program=StencilProgram(grid_shape=GRID, ensemble=2),
                        state=st_, steps=1).validate()
    with pytest.raises(ValueError, match="steps"):
        ForecastRequest(program=prog, state=st_, steps=-1).validate()
    with pytest.raises(ValueError, match="dtype"):
        ForecastRequest(program=StencilProgram(grid_shape=GRID,
                                               dtype="bfloat16"),
                        state=st_, steps=1).validate()
    with pytest.raises(ValueError, match="grid"):
        ForecastRequest(program=StencilProgram(grid_shape=(4, 12, 16)),
                        state=st_, steps=1).validate()
    with pytest.raises(ValueError, match="leading ensemble"):
        ForecastRequest(program=prog, state=_state(0, ensemble=2),
                        steps=1).validate()
    with pytest.raises(ValueError, match="slots"):
        ForecastEngine(slots=0, device="cpu")
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        ForecastEngine(slots=1, mesh=object(), device="cpu")
    eng = ForecastEngine(slots=1, device="cpu")
    rid = eng.submit(ForecastRequest(program=prog, state=st_, steps=0))
    res = eng.drain()[rid]
    assert res.rounds == 0 and res.status == "ok"
    for got, want in zip(wprog.state_leaves(res.state),
                         wprog.state_leaves(st_), strict=True):
        assert torch.equal(got, want)
        # the result shares nothing with the request
        assert got.data_ptr() != want.data_ptr()


def test_plan_cache_exactly_m_compiles(monkeypatch):
    calls = []
    real_compile = wprog.compile

    def spy(program, *a, **kw):
        calls.append(program)
        return real_compile(program, *a, **kw)

    monkeypatch.setattr(wprog, "compile", spy)
    progs = [StencilProgram(grid_shape=GRID),
             StencilProgram(grid_shape=GRID, op="hdiff")]
    eng = ForecastEngine(slots=2, device="cpu")
    reqs = []
    for i in range(6):
        prog = progs[i % 2]
        st_ = _state(20 + i)
        reqs.append((eng.submit(ForecastRequest(program=prog, state=st_,
                                                steps=1 + i % 3)), st_))
    results = eng.drain()
    assert sorted(results) == sorted(r for r, _ in reqs)
    assert len(calls) == 2, [p.op for p in calls]
    assert {p.ensemble for p in calls} == {eng.slots}
    s = eng.stats()
    assert s["plan_cache_misses"] == 2 and s["plan_cache_hits"] == 4
    assert s["plan_cache_hit_rate"] == pytest.approx(4 / 6)
    assert plan_cache_key(progs[0], ensemble=2) in eng._plans
    for rid, st_ in reqs:
        _assert_bit_identical(results[rid], st_)


def test_per_request_latency_accounting():
    prog = StencilProgram(grid_shape=GRID)
    eng = ForecastEngine(slots=2, device="cpu")
    rids = [eng.submit(ForecastRequest(program=prog, state=_state(30 + i),
                                       steps=steps))
            for i, steps in enumerate([1, 6, 4])]
    res = eng.drain()
    short, long_, queued = (res[r] for r in rids)
    assert short.latency_s > 0 and long_.latency_s > short.latency_s
    assert long_.rounds == 6 and short.rounds == 1
    assert queued.queue_wait_s > short.queue_wait_s
    assert 0 < eng.stats()["occupancy"] <= 1


def _workload():
    progs = [StencilProgram(grid_shape=GRID),
             StencilProgram(grid_shape=GRID, op="hdiff"),
             StencilProgram(grid_shape=(4, 12, 16), dtype="bfloat16"),
             StencilProgram(grid_shape=GRID, variant="kstep", k_steps=2)]
    out = []
    for i, steps in enumerate([3, 5, 2, 4, 1, 5]):
        prog = progs[i % 4]
        out.append(ForecastRequest(program=prog,
                                   state=_state(100 + i, prog.grid_shape,
                                                prog.dtype),
                                   steps=steps, rid=i))
    return out


def _assert_same_results(got, want):
    assert sorted(got) == sorted(want)
    for rid, r in want.items():
        assert got[rid].status == r.status and got[rid].steps == r.steps
        got_l = wprog.state_leaves(got[rid].state)
        want_l = wprog.state_leaves(r.state)
        assert len(got_l) == len(want_l)
        for i, (g, w) in enumerate(zip(got_l, want_l)):
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=f"rid={rid} leaf {i}")


def test_checkpoint_restart_matches_uninterrupted(tmp_path):
    ref = ForecastEngine(slots=2, device="cpu")
    for r in _workload():
        ref.submit(r)
    want = ref.drain()
    eng = ForecastEngine(slots=2, device="cpu", ckpt_dir=str(tmp_path))
    for r in _workload():
        eng.submit(r)
    eng.pump()
    eng.pump()
    step = eng.checkpoint()
    assert eng.has_work()
    del eng
    eng2 = ForecastEngine.restore(str(tmp_path), step, device="cpu")
    assert eng2.has_work() and eng2.slots == 2
    _assert_same_results(eng2.drain(), want)


def test_crash_restore_at_every_round_boundary(tmp_path):
    prog = StencilProgram(grid_shape=GRID)

    def submit_all(eng):
        return [eng.submit(ForecastRequest(program=prog,
                                           state=_state(60 + i),
                                           steps=steps))
                for i, steps in enumerate([3, 1, 2, 4])]

    ref_eng = ForecastEngine(slots=2, device="cpu")
    rids = submit_all(ref_eng)
    want = ref_eng.drain()
    d = str(tmp_path)
    wd = ForecastEngine(slots=2, device="cpu", ckpt_dir=d,
                        ckpt_every_rounds=1, ckpt_keep=0)
    assert submit_all(wd) == rids
    wd.drain()
    saved = sorted(int(p.split("_")[1]) for p in __import__("os").listdir(d)
                   if p.startswith("step_"))
    assert len(saved) == wd.stats()["watchdog_checkpoints"] >= 3
    for step in saved:
        eng = ForecastEngine.restore(d, step, device="cpu")
        eng.ckpt_every_rounds = None
        _assert_same_results(eng.drain(), want)


# ---------------------------------------------------------------------------
# Engine checkpoints across the packages
# ---------------------------------------------------------------------------


def _jax_workload():
    progs = [jprog.StencilProgram(grid_shape=GRID),
             jprog.StencilProgram(grid_shape=GRID, op="hdiff")]
    out = []
    for i, steps in enumerate([2, 3, 1, 2]):
        prog = progs[i % 2]
        js = jfields.initial_state(jax.random.PRNGKey(200 + i), GRID)
        out.append((prog, js, steps))
    return out


def _assert_within_tolerance(got, want, js, steps):
    """One request's fp32 fields, one package's drain against the other's:
    within 1e-5, plus, for the dycore, `limiter_flip_bound` of its last
    step's hdiff input (f + dt * stage, from the JAX package's solo run of
    the steps before it) at that input's fragile points."""
    prog = jprog.StencilProgram.from_json(want.program.to_json())
    prev = jprog.compile(prog).run(js, steps - 1) if prog.op == "dycore" \
        else None
    for name in prog.fields:
        g = _np(convert.tensor_to_numpy(got.state.fields[name])
                if isinstance(got.state.fields[name], torch.Tensor)
                else got.state.fields[name])
        w_t = want.state.fields[name]
        w = w_t.numpy() if isinstance(w_t, torch.Tensor) else _np(w_t)
        bound = 0.0
        if prev is not None:
            s_t = want.state.stage_tens[name]
            stage = s_t.numpy() if isinstance(s_t, torch.Tensor) \
                else _np(s_t)
            f2 = _np(prev.fields[name]) + np.float32(prog.dt) * stage
            bound = fused_ref.limiter_flip_bound(
                torch.from_numpy(np.ascontiguousarray(f2))).numpy()
        assert (np.abs(g - w) <= TOL + bound).all(), (
            name, float(np.abs(g - w).max()))


@pytest.fixture(scope="module")
def jax_engine_run(tmp_path_factory):
    """The JAX engine, checkpointed after one round (requests in flight,
    one finished, one queued), then drained; and its checkpoint."""
    d = str(tmp_path_factory.mktemp("jax_engine"))
    eng = JEngine(slots=2, ckpt_dir=d)
    for prog, js, steps in _jax_workload():
        eng.submit(JRequest(program=prog, state=js, steps=steps))
    eng.pump()
    step = eng.checkpoint()
    mid = {rid: r for rid, r in eng.results.items()}
    lanes = {k.op: jax.tree_util.tree_map(np.asarray, ln.batch)
             for k, ln in eng._lanes.items()}
    return d, step, mid, lanes, eng.drain()


def test_jax_engine_checkpoint_restores_and_drains_in_the_port(
        jax_engine_run):
    d, step, mid, lanes, want = jax_engine_run
    eng = ForecastEngine.restore(d, step, device="cpu")
    assert sorted(eng.results) == sorted(mid)
    for rid, r in mid.items():            # finished before the checkpoint
        for name in r.program.fields:
            np.testing.assert_array_equal(
                eng.results[rid].state.fields[name].numpy(),
                _np(r.state.fields[name]))
    got = eng.drain()
    assert sorted(got) == sorted(want)
    work = _jax_workload()
    for rid, w in want.items():
        assert got[rid].status == w.status == "ok"
        assert got[rid].rounds == w.rounds
        _assert_within_tolerance(got[rid], w, work[rid][1], w.steps)


def test_port_engine_checkpoint_restores_and_drains_in_jax(tmp_path):
    d = str(tmp_path)
    eng = ForecastEngine(slots=2, device="cpu", ckpt_dir=d)
    for prog, js, steps in _jax_workload():
        eng.submit(ForecastRequest(
            program=StencilProgram.from_json(prog.to_json()),
            state=_to_port(js), steps=steps))
    eng.pump()
    step = eng.checkpoint()
    want = eng.drain()
    jeng = JEngine.restore(d, step)
    got = jeng.drain()
    assert sorted(got) == sorted(want)
    work = _jax_workload()
    for rid, w in want.items():
        assert got[rid].status == w.status == "ok"
        _assert_within_tolerance(got[rid], w, work[rid][1], w.steps)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("layout", ["stacked", "cropped"])
def test_guard_kernel_bit_equal_to_plain(dtype, layout, cuda):
    gen = torch.Generator().manual_seed(3)
    E, nz, ny, nx = 3, 5, 9, 40
    dt = fields.torch_dtype(dtype)
    if layout == "stacked":
        base = torch.randn((E, 13, nz, ny, nx), generator=gen).to(dt)
        leaves = list(base.unbind(1))
    else:     # x offset by 2 elements: rows not 16-byte aligned
        base = torch.randn((E, 13, nz, ny + 4, nx + 4), generator=gen).to(dt)
        leaves = [t[..., 2:2 + ny, 2:2 + nx] for t in base.unbind(1)]
    leaves[0][1, 2, 3, 4] = float("nan")
    leaves[5][2, 0, 0, 0] = 3e6
    leaves[7][0] = -0.0
    want_ok, want_fp = guard_ref.slot_guard(leaves, 1e6)
    dev = [t.to(cuda) if layout == "stacked" else t for t in leaves]
    if layout == "cropped":
        dev = [t[..., 2:2 + ny, 2:2 + nx] for t in base.to(cuda).unbind(1)]
    _build.reset_launches()
    ok, fp = slot_guard_cuda(dev, 1e6)
    assert _build.LAUNCHES["slot_guard"] == 1
    assert ok.tolist() == want_ok.tolist() == [True, False, False]
    assert fp.tolist() == want_fp.tolist()


@pytest.mark.cuda
def test_engine_drain_on_the_card_bit_equal_to_solo(cuda):
    grid = (8, 32, 32)
    progs = [StencilProgram(grid_shape=grid),
             StencilProgram(grid_shape=grid, dtype="bfloat16"),
             StencilProgram(grid_shape=grid, variant="kstep", k_steps=2)]
    eng = ForecastEngine(slots=2, device=cuda)
    reqs = []
    for i, steps in enumerate([3, 2, 5, 1, 4, 3]):
        prog = progs[i % 3]
        st_ = _state(i, grid, prog.dtype)
        reqs.append((eng.submit(ForecastRequest(program=prog, state=st_,
                                                steps=steps)), st_, prog))
    _build.reset_launches()
    res = eng.drain()
    s = eng.stats()
    assert _build.LAUNCHES["slot_guard"] == s["rounds"]
    assert s["fallback_compiles"] == 0 and s["plan_fallbacks"] == {}
    assert s["fingerprint_divergence"] == 0 and s["scrubbed_idle_slots"] == 0
    # the kernels wrote field-stacked lanes: the next round copies nothing
    assert all(_stacked(lane.batch) for lane in eng._lanes.values())
    for rid, st_, prog in reqs:
        want = wprog.compile(prog, device=cuda).run(
            wprog.map_state(st_, lambda t: t.to(cuda)), res[rid].steps)
        for i, (g, w) in enumerate(zip(wprog.state_leaves(res[rid].state),
                                       wprog.state_leaves(want),
                                       strict=True)):
            assert torch.equal(g, w.cpu()), (rid, i)
