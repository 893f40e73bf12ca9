"""The per-rank op-cost counter (`repro_torch.core.op_cost`), the twin of
the JAX package's `repro.core.hlo_cost`.

* The rules: on a product, an elementwise op, a transcendental and a
  reduce the counter gives what `hlo_cost` gives the same function's
  compiled HLO (but for its few scalar ops); views cost nothing, a
  gather twice its output.
* The kernels' trace route: a fake or meta tensor reaching the flash,
  cross-entropy or LRU wrapper launches nothing and records one call with
  the kernel's own cost (`flash_flops` and `flash_traffic_bytes`, the
  latter the JAX package's formula; 2·N·D·Vp; bytes in and out).
* A whole reduced training step traced on fake tensors builds nothing,
  runs no `nvcc` and leaves `_build.LAUNCHES` as it was, and records the
  launches phase 7's plan gives a step.
* Per rank, below DTensor (one subprocess, a fake world of 512 ranks):
  a (256, 4096) @ (4096, 8192) product sharded `[Shard(0), Replicate()]`
  @ `[Replicate(), Shard(1)]` on a (16, 32) mesh counts rank 0's
  2·16·4096·256 = 33,554,432 FLOPs (`FlopCounterMode` counts the global
  17,179,869,184); a `Shard(0)` -> `Replicate()` redistribute records its
  all-gather's result bytes; a mesh dim of one records nothing;
  `distribute_tensor` records its scatter and broadcast;
  `make_device_mesh` makes a "cuda" mesh on the fake world without a card.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import op_cost

ROOT = Path(__file__).resolve().parents[1]


def _count(fn, *shapes, dtype=torch.float32):
    """(cost, output) of fn over fake inputs of `shapes`."""
    c = op_cost.OpCounter()
    with c:
        args = [torch.empty(s, dtype=dtype) for s in shapes]
        with c.counting():
            out = fn(*args)
    return c.cost, out


def test_rules_match_hlo_cost_on_a_small_function():
    """tanh(x @ w).sum() in fp32: the dot, the transcendental and the
    reduce as `hlo_cost` counts the compiled HLO, but for the HLO's few
    scalar ops (the reduce's own add computation)."""
    import jax
    import jax.numpy as jnp

    from repro.core import hlo_cost

    m, k, n = 64, 128, 32
    spec = [jax.ShapeDtypeStruct(s, jnp.float32) for s in ((m, k), (k, n))]
    compiled = jax.jit(lambda x, w: jnp.tanh(x @ w).sum()).lower(
        *spec).compile()
    want = hlo_cost.analyze_text(compiled.as_text())
    got, _ = _count(lambda x, w: torch.tanh(x @ w).sum(), (m, k), (k, n))
    assert got.flops == 2 * m * k * n + m * n
    assert 0 <= want.flops - got.flops <= 8
    assert got.transcendentals == want.transcendentals == m * n


def test_rules_by_kind():
    cost, _ = _count(lambda a, b: torch.bmm(a, b), (3, 4, 5), (3, 5, 6))
    assert cost.flops == 2 * 3 * 4 * 6 * 5
    assert cost.bytes_accessed == 4 * (3 * 4 * 5 + 3 * 5 * 6 + 3 * 4 * 6)
    cost, _ = _count(lambda c, a, b: torch.addmm(c, a, b), (6,), (4, 5),
                     (5, 6))
    assert cost.flops == 2 * 4 * 6 * 5 + 4 * 6
    cost, _ = _count(lambda x: torch.softmax(x, -1), (8, 16))
    assert (cost.flops, cost.transcendentals) == (4 * 128, 128)
    cost, _ = _count(lambda x: x.view(16, 8).t().reshape(-1)[:5], (8, 16))
    # views cost nothing; the reshape of a transpose copies
    assert cost.flops == 0 and cost.bytes_accessed == 2 * 128 * 4
    cost, _ = _count(lambda t, i: t[i.long()], (1000, 64), (10,),
                     dtype=torch.float32)
    # the index: twice its output; the cast to int64: in and out
    assert cost.bytes_accessed == 2 * 10 * 64 * 4 + 10 * (4 + 8)


def test_counting_is_a_window_and_tracks_live_bytes():
    c = op_cost.OpCounter()
    with c:
        a = torch.empty(1024, dtype=torch.float32)
        b = a * 2                                         # not counted
        with c.counting():
            d = a + b
            e = d * d
            del d
        assert c.cost.ops == 2 and c.cost.flops == 2048
        assert c.peak_live_bytes == 4 * 4096
        assert c.live_bytes == 3 * 4096
        del e
    assert op_cost.active() is None


def _fake_qkv(c, b, t, s, h, kh, hd, dtype=torch.bfloat16, device="cpu"):
    with c:
        return (torch.empty(b, t, h, hd, dtype=dtype, device=device),
                torch.empty(b, s, kh, hd, dtype=dtype, device=device),
                torch.empty(b, s, kh, hd, dtype=dtype, device=device))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100)])
def test_flash_trace_records_its_formula(causal, window):
    from repro.kernels.flash_attention.ops import \
        flash_traffic_bytes as jax_bytes
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash import auto_blocks

    b, t, s, h, kh, hd = 2, 1000, 1000, 8, 2, 64
    c = op_cost.OpCounter()
    q, k, v = _fake_qkv(c, b, t, s, h, kh, hd)
    with c, c.counting():
        o = ops.flash_mha(q, k, v, causal=causal, window=window)
    assert o.shape == q.shape and o.dtype == q.dtype and op_cost.is_fake(o)
    bq, bk = auto_blocks(hd, dtype=torch.bfloat16)
    assert c.cost.kernels["flash_attn"]["calls"] == 1
    assert c.cost.kernels["flash_attn"]["bytes"] == jax_bytes(
        b, t, s, h, kh, hd, 2, block_q=bq) == ops.flash_traffic_bytes(
        b, t, s, h, kh, hd, 2)
    # the (query, key) pairs of every visited block, by brute force
    pairs = 0
    for qa in range(0, t, bq):
        qe = min(qa + bq, t) - 1
        ks = [kb for kb in range(0, s, bk)
              if (not causal or kb <= qe)
              and (not window or kb + bk - 1 >= qa - window + 1)]
        pairs += (qe - qa + 1) * len(ks) * bk
    assert c.cost.kernels["flash_attn"]["flops"] == 4 * b * h * hd * pairs
    if not causal:
        assert pairs == t * math.ceil(s / bk) * bk


def test_xent_and_lru_traces_record_their_formulas():
    from repro_torch.kernels.lru_scan import ops as lru
    from repro_torch.kernels.xent import ops as xent

    n, d, vp = 300, 64, 1000
    c = op_cost.OpCounter()
    with c:
        h = torch.empty(n, d, dtype=torch.bfloat16)
        w = torch.empty(d, vp, dtype=torch.bfloat16)
        tg = torch.empty(n, dtype=torch.int32)
        a = torch.empty(2, 50, 96, dtype=torch.float32)
        with c.counting():
            nll, lse = xent.xent_rows(h, w, tg, vocab=900)
            out = lru.lru_scan(a, a)
    assert nll.shape == lse.shape == (n,) and out.shape == a.shape
    k = c.cost.kernels
    assert k["xent"] == {"calls": 1, "flops": 2.0 * n * d * vp,
                         "bytes": 2 * (n * d + d * vp) + 4 * n + 8 * n}
    assert k["lru_scan"] == {"calls": 1, "flops": 2.0 * a.numel(),
                             "bytes": 3 * 4 * a.numel()}


def test_meta_tensors_take_the_trace_route():
    from repro_torch.kernels.flash_attention import ops

    q = torch.empty(1, 64, 4, 32, dtype=torch.bfloat16, device="meta")
    c = op_cost.OpCounter()
    with c.counting():
        o = ops.flash_mha(q, q, q)
    assert o.is_meta and c.cost.kernels["flash_attn"]["calls"] == 1


def test_a_traced_train_step_builds_and_launches_nothing(monkeypatch):
    """A reduced recurrentgemma step (flash, xent and the LRU sweep with
    their backwards) on fake tensors: no build, no `nvcc`, no launch; the
    recorded calls are phase 7's plan for a step."""
    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.models import api, lm
    from repro_torch.train import loop, optim

    def refuse(*a, **k):
        raise AssertionError("a trace tried to build or run a program")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "_nvcc", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    before = dict(_build.LAUNCHES)
    cfg = registry.reduced_config(registry.get_config("recurrentgemma-9b"))
    model = api.build(cfg, device="cpu")
    step = loop.make_train_step(model, optim.OptConfig())
    c = op_cost.OpCounter()
    with c:
        params = model.param_shapes()
        for name, p in list(params.named_parameters()):
            from repro_torch.parallel import sharding as shd
            shd._set_param(params, name, torch.empty(p.shape,
                                                     dtype=p.dtype))
        opt_state = optim.init_opt_state(params)
        batch = {"tokens": torch.empty(2, 32, dtype=torch.int32)}
        with c.counting():
            step(params, opt_state, batch)
    assert _build.LAUNCHES == before
    kinds = lm.layer_kinds(cfg)
    recomputed = kinds[:cfg.n_repeats * len(cfg.pattern)]
    assert c.cost.kernel_calls() == {
        "flash_attn": sum(k not in ("rec", "ssd")
                          for k in kinds + recomputed),
        "lru_scan": 2 * kinds.count("rec") + recomputed.count("rec"),
        "xent": 1}
    assert c.cost.flops > 0 and c.cost.bytes_accessed > 0


_WORLD = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.core import op_cost
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_device_mesh

dryrun.fake_world(512)
mesh = make_device_mesh((16, 32), ("data", "model"), device_type="cpu")
one = make_device_mesh((1, 512), ("data", "model"), device_type="cpu")
out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
c = op_cost.OpCounter()
with c:
    a = torch.empty(256 // 16, 4096, dtype=torch.bfloat16)
    b = torch.empty(4096, 8192 // 32, dtype=torch.bfloat16)
    A = DTensor.from_local(a, mesh, [Shard(0), Replicate()], run_check=False)
    B = DTensor.from_local(b, mesh, [Replicate(), Shard(1)], run_check=False)
    with c.counting():
        C = A @ B
    out["flops"] = c.cost.flops
    out["local"] = list(C.to_local().shape)
    with FlopCounterMode(display=False) as fc:
        A @ B
    out["flop_counter"] = fc.get_total_flops()
    with c.counting():
        A.redistribute(mesh, [Replicate(), Replicate()])
    out["gather"] = c.cost.collective_bytes
with c:
    X = DTensor.from_local(torch.empty(8, 16), one, [Shard(0), Replicate()],
                           run_check=False)
    with c.counting():
        X.redistribute(one, [Replicate(), Replicate()])
    out["size_one"] = c.cost.collective_bytes
    full = torch.empty(512, 8)
    with c.counting():
        distribute_tensor(full, mesh, [Shard(0), Replicate()])
    out["distribute"] = c.cost.collective_bytes
    # the c10d ops of the sequence-parallel seams, on the 32-rank group
    g = mesh.get_group("model")
    x = torch.empty(4, 16)
    ag = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    rs = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    for name, fn in (
            ("_allgather_base", lambda: ag(
                torch.empty(32 * 4, 16), x, group=g)),
            ("_reduce_scatter_base", lambda: rs(
                torch.empty(1, 2), torch.empty(32, 2), group=g)),
            ("reduce_scatter", lambda: dist.reduce_scatter(
                torch.empty(4, 16), [x] * 32, group=g))):
        with c.counting():
            fn()
        out[name] = c.cost.collective_bytes
cuda = make_device_mesh((2, 4), ("data", "model"))
out["cuda_mesh"] = [cuda.device_type, list(cuda.shape)]
try:
    make_device_mesh((2, 512), ("data", "model"))
except RuntimeError as e:
    out["too_big"] = str(e)
dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("op_cost")
    res = subprocess.run(
        [sys.executable, "-c", _WORLD, str(tmp / "out.json")],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads((tmp / "out.json").read_text())


def test_sharded_product_counts_rank_zeros_work(world):
    assert (world["backend"], world["world"]) == ("fake", 512)
    assert world["local"] == [16, 256]
    assert world["flops"] == 2 * 16 * 4096 * 256 == 33_554_432
    assert world["flop_counter"] == 2 * 256 * 4096 * 8192 == 17_179_869_184


def test_redistribute_records_its_all_gather(world):
    assert world["gather"] == {"all-gather": 256 * 4096 * 2}
    assert world["size_one"] == {}


def test_distribute_tensor_records_its_scatter_and_broadcast(world):
    """`distribute_tensor` (a microbatched step's batch split) scatters
    over "data" and broadcasts rank 0's shard over "model"."""
    assert world["distribute"] == {"scatter": 512 // 16 * 8 * 4,
                                   "broadcast": 512 // 16 * 8 * 4}


@pytest.mark.parametrize("op,want", [
    ("_allgather_base", {"all-gather": 32 * 4 * 16 * 4}),
    ("_reduce_scatter_base", {"reduce-scatter": 2 * 4}),
    ("reduce_scatter", {"reduce-scatter": 4 * 16 * 4})])
def test_c10d_collectives_are_counted_by_kind(world, op, want):
    """`dist.all_gather_into_tensor`, `dist.reduce_scatter_tensor` and
    `dist.reduce_scatter` (the c10d ops `_allgather_base`,
    `_reduce_scatter_base`, `reduce_scatter`) record their result bytes
    under their kind."""
    assert world[op] == want


def test_device_mesh_on_a_fake_world(world):
    assert world["cuda_mesh"] == ["cuda", [2, 4]]
    assert "fake world has 512" in world["too_big"]
