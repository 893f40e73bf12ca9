"""The port's sharding rules, activation seams, gradient compression,
sharded data, checkpoints and `fit` on a device mesh, against the JAX
package's and against themselves.

In this process: `parallel/sharding.py`'s rule table for all ten reduced
configurations, kinds "train" and "serve", on (2, 2), (1, 4) and (1, 8)
meshes (granite's 4 experts stop dividing the model axis there), leaf for
leaf equal to JAX `params_sharding` on an `AbstractMesh` (the port's
parameter i maps onto the JAX leaf that `convert.params_to_numpy` puts it
in; a stacked leaf's leading None dropped); `cache_sharding` for the four
architectures of `test_cache_specs_are_rank_valid`; `batch_sharding` and
`data_spec` on (1, 1), (2, 2), (1, 4) and (2, 2, 2); the int8 codec's
error bound and unbiasedness, as `tests/test_compression_sharding.py`
holds the JAX one; the seams are the identity without rules.

Four gloo ranks run the rest once for the file, in one subprocess
(`ranks`): `compressed_psum` over a 4-rank axis, "none" and "bf16" held
to JAX's `shard_map` result on four host devices (`reference`) within
fp32 / bf16 rounding, "int8" and `exact_compressed_psum` within the
codec's bound (the noise generators differ by design); `iterator(mesh=)`
yields each rank's rows of `lm_batch` as DTensors; `fit(mesh=)` resumed
from a checkpoint equals an uninterrupted run bit for bit; a checkpoint
restores bit for bit one device -> (2, 2) -> (1, 4) -> one device, each
leaf placed by the current mesh's rules. The launcher trains on a (2, 2)
mesh under torchrun.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.parallel import sharding as jshd
from repro_torch.configs import registry as treg
from repro_torch.models import api, convert
from repro_torch.parallel import compression, policy
from repro_torch.parallel import sharding as shd

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model"))}
BATCH_MESHES = {"1x1": ((1, 1), ("data", "model")),
                "2x2": ((2, 2), ("data", "model")),
                "1x4": ((1, 4), ("data", "model")),
                "pod": ((2, 2, 2), ("pod", "data", "model"))}
SEED_GRADS = 5


class _Mesh:
    """A mesh's names and sizes only (the rules read nothing else)."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _cfg(reg, arch):
    return reg.reduced_config(reg.get_config(arch))


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def _port_to_jax_leaves(cfg):
    """[(port name, JAX path, index along a stacked leaf's scan axis or
    None)]: the port's parameter i filled with i, carried to the JAX tree
    by `params_to_numpy`, read back."""
    import dataclasses
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = api.build(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    names = [n for n, _ in params.named_parameters()]
    with torch.no_grad():
        for i, p in enumerate(params.parameters()):
            p.fill_(float(i))
    tree = convert.params_to_numpy(cfg, params)
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(str(k.key) for k in path)
        stacked = any(k in jshd.STACK_KEYS for k in keys)
        for r, sl in enumerate(leaf if stacked else [leaf]):
            out.append((names[int(sl.flat[0])] if sl.size else None, keys,
                        r if stacked else None))
    assert sorted(n for n, _, _ in out) == sorted(names)
    return out


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_params_sharding_is_the_jax_packages(arch, kind):
    """Leaf for leaf, on three meshes: the port's spec of each parameter is
    JAX `params_sharding`'s for the leaf it sits in (a stacked leaf's
    leading None dropped)."""
    jmodel = japi.build(_cfg(jreg, arch))
    tcfg = _cfg(treg, arch)
    shapes = api.build(tcfg, device="cpu").param_shapes()
    leaves = _port_to_jax_leaves(tcfg)
    for shape, axes in MESHES.values():
        want = jshd.params_sharding(jmodel.param_shapes(),
                                    AbstractMesh(shape, axes), kind)
        got = shd.params_sharding(shapes, _Mesh(shape, axes), kind)
        for name, keys, r in leaves:
            node = want
            for k in keys:
                node = node[k]
            spec = tuple(node.spec)
            if r is not None:
                assert spec[0] is None
                spec = spec[1:]
            assert tuple(got[name]) == spec, (name, keys, shape)


def _jax_cache_path(cfg, i):
    period = len(cfg.pattern)
    if i < cfg.n_repeats * period:
        return ("superblocks", f"b{i % period}"), True
    return (f"rem{i - cfg.n_repeats * period}",), False


@pytest.mark.parametrize("arch", ["yi-34b", "recurrentgemma-9b",
                                  "mamba2-1.3b", "whisper-medium"])
def test_cache_sharding_is_the_jax_packages(arch):
    """The port's per-layer cache specs are JAX `cache_sharding`'s for the
    layer's (stacked) leaf, on (2, 2) and a ("pod", "data", "model") mesh,
    at batch 4 and 1 (sequence over ("data", "model"))."""
    jmodel = japi.build(_cfg(jreg, arch))
    tcfg = _cfg(treg, arch)
    for batch in (4, 1):
        jcache = jax.eval_shape(lambda: jmodel.init_cache(batch, 32))
        tcache = api.build(tcfg, device="cpu").init_cache(batch, 32)
        for shape, axes in (((2, 2), ("data", "model")),
                            ((2, 2, 2), ("pod", "data", "model"))):
            want = jshd.cache_sharding(jcache, AbstractMesh(shape, axes),
                                       batch)
            got = shd.cache_sharding(tcache, _Mesh(shape, axes), batch,
                                     tcfg)
            if tcfg.encdec:
                pairs = [(("dec", "self", k), True, spec)
                         for layer in got["dec"] for k, spec in layer.items()]
                pairs.append((("enc",), False, got["enc"]))
            else:
                pairs = []
                for i, layer in enumerate(got):
                    prefix, stacked = _jax_cache_path(tcfg, i)
                    pairs += [(prefix + (k,), stacked, spec)
                              for k, spec in layer.items()]
            for keys, stacked, spec in pairs:
                node = want
                for k in keys:
                    node = node[k]
                w = tuple(node.spec)
                w = w + (None,) * (len(spec) + stacked - len(w))
                assert tuple(spec) == (w[1:] if stacked else w), (keys,
                                                                 shape)


@pytest.mark.parametrize("mesh", list(BATCH_MESHES))
def test_batch_rules_are_the_jax_packages(mesh):
    shape, axes = BATCH_MESHES[mesh]
    jm, tm = AbstractMesh(shape, axes), _Mesh(shape, axes)
    for b in (1, 2, 3, 4, 7, 8, 16):
        want = jshd.batch_sharding(jm, b)
        assert shd.batch_sharding(tm, b) == want
        for ndim in (1, 2, 3):
            assert tuple(shd.data_spec(tm, b, ndim)) == tuple(
                jshd.data_spec(jm, b, ndim))


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    class DM:                       # a DeviceMesh's names and sizes
        mesh_dim_names = ("pod", "data", "model")

        def size(self, i):
            return 2

    got = shd.placements(shd.P(("pod", "data"), None, "model"), DM())
    assert got == [Shard(0), Shard(0), Shard(2)]
    assert shd.placements(shd.P(None, "data"), DM()) == [
        Replicate(), Shard(1), Replicate()]
    assert shd.mesh_shape(DM()) == {"pod": 2, "data": 2, "model": 2}


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-medium"])
def test_param_shapes_are_the_parameters(arch):
    cfg = _cfg(treg, arch)
    model = api.build(cfg, device="cpu")
    meta = dict(model.param_shapes().named_parameters())
    real = dict(model.init(torch.Generator().manual_seed(0))
                .named_parameters())
    assert list(meta) == list(real)
    for k, p in real.items():
        assert meta[k].device.type == "meta"
        assert (meta[k].shape, meta[k].dtype) == (p.shape, p.dtype)


def test_seams_are_the_identity_without_rules():
    x = torch.randn(2, 3, 4)
    for fn in (policy.batch_local, policy.enter_tp, policy.leave_tp,
               policy.gather_model, policy.batch_mean, policy.gather_batch):
        assert fn(x) is x
    assert policy.gather(x) is x
    cfg = _cfg(treg, "tinyllama-1.1b")
    assert not any(policy.is_tp(cfg, layer) for layer in
                   ("attn", "xattn", "ffn", "moe", "rec"))
    params = api.build(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert policy.gather_block_weights(params.blocks[0].params) is \
        params.blocks[0].params


def test_device_mesh_refuses_what_it_cannot_run(monkeypatch):
    from repro_torch.launch.mesh import make_device_mesh
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="processes"):
        make_device_mesh((2, 2), ("data", "model"), device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_device_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError):
        make_device_mesh((1, 1), ("data", "model"), device_type="tpu")


# ---------------------------------------------------------------------------
# the codec (`tests/test_compression_sharding.py`'s properties)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_int8_roundtrip_error_bound(seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(16, 64, generator=g)
    q, s = compression.int8_rowwise_encode(x, g)
    assert q.dtype == torch.int8 and s.shape == (16, 1)
    err = (compression.int8_rowwise_decode(q, s) - x).abs()
    assert bool((err <= s + 1e-6).all())
    v = torch.randn(64, generator=g)
    qv, sv = compression.int8_rowwise_encode(v, g)
    assert qv.shape == v.shape and sv.shape == (1, 1)


def test_int8_unbiased():
    """Stochastic rounding: E[decode(encode(x))] == x."""
    x = torch.full((1, 64), 0.3712) * torch.linspace(-1, 1, 64)[None]
    g = torch.Generator().manual_seed(0)
    acc = torch.zeros((1, 64), dtype=torch.float64)
    n = 400
    for _ in range(n):
        acc += compression.int8_rowwise_decode(
            *compression.int8_rowwise_encode(x, g)).double()
    np.testing.assert_allclose((acc / n).numpy(), x.double().numpy(),
                               atol=5e-4)


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

def _grads():
    """Rank r's gradient tree, r = 0..3."""
    rng = np.random.default_rng(SEED_GRADS)
    return [{"w": rng.normal(size=(8, 16)).astype(np.float32) * (1 + r),
             "b": rng.normal(size=(16,)).astype(np.float32)}
            for r in range(4)]


_RANKS = r'''
import copy, dataclasses, datetime, os, pickle, socket, sys, tempfile
import traceback
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, port, inp, outp):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=300))
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import api
    from repro_torch.parallel import compression, sharding as shd
    from repro_torch.train import loop, optim

    data = pickle.load(open(inp, "rb"))
    m22 = make_device_mesh((2, 2), ("data", "model"), device_type="cpu")
    m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    dp = init_device_mesh("cpu", (4,), mesh_dim_names=("dp",))
    tmp = data["tmp"]
    out = {}

    def psum():
        tree = {k: torch.from_numpy(v) for k, v in data["grads"][rank].items()}
        gen = torch.Generator().manual_seed(100 + rank)
        res = {m: compression.compressed_psum(tree, dp, "dp", m, generator=gen)
               for m in compression.METHODS}
        res["exact"] = compression.exact_compressed_psum(tree, dp, "dp",
                                                         generator=gen)
        return {m: {k: v.numpy() for k, v in t.items()}
                for m, t in res.items()}

    def iterate():
        cfg = registry.reduced_config(registry.get_config("whisper-medium"))
        it = synthetic.iterator(cfg, 4, 8, seed=3, start_step=2, prefetch=1,
                                device="cpu", mesh=m22)
        got = []
        for _ in range(2):
            b = next(it)
            got.append({k: (v.to_local().numpy(), v.full_tensor().numpy(),
                            [(type(p).__name__, getattr(p, "dim", None))
                             for p in v.placements], tuple(v.shape))
                        for k, v in b.items()})
        it.close()
        return got

    def small(arch):
        cfg = dataclasses.replace(
            registry.reduced_config(registry.get_config(arch), layers=2),
            dtype="float32", param_dtype="float32")
        return cfg, api.build(cfg, device="cpu")

    def resume():
        cfg, model = small("tinyllama-1.1b")
        oc = optim.OptConfig(lr=5e-3, warmup_steps=1, total_steps=4)
        kw = dict(opt_cfg=oc, log_every=0, log_fn=lambda *_: None,
                  mesh=m22)
        it = lambda: synthetic.iterator(cfg, 4, 16, seed=1, prefetch=0,
                                        device="cpu", mesh=m22)
        full, _, h_full = loop.fit(model, it(), steps=4, **kw)
        d = os.path.join(tmp, "resume")
        loop.fit(model, it(), steps=2, ckpt_dir=d, ckpt_every=1, **kw)
        again, _, h_again = loop.fit(model, it(), steps=4, ckpt_dir=d,
                                     ckpt_every=1, **kw)
        same = all(torch.equal(a.full_tensor(), b.full_tensor())
                   for a, b in zip(full.parameters(), again.parameters()))
        return {"same": same, "steps": [h["step"] for h in h_again],
                "losses": ([h["loss"] for h in h_full[2:]],
                           [h["loss"] for h in h_again]),
                "latest": ckpt.latest_step(d)}

    def elastic():
        cfg, model = small("granite-moe-3b-a800m")
        p0 = model.init(torch.Generator().manual_seed(0))
        o0 = optim.init_opt_state(p0)
        batch = {k: torch.from_numpy(v) for k, v in
                 synthetic.lm_batch(cfg, 0, 0, 4, 16).items()}
        p0, o0, _ = loop.make_train_step(model, optim.OptConfig())(p0, o0,
                                                                    batch)
        want = ckpt._train_arrays(p0, o0)
        d = [os.path.join(tmp, f"elastic{i}") for i in range(3)]
        ckpt.save(d[0], 1, p0, o0)                 # one device, rank 0
        dist.barrier()
        res = {}
        for i, mesh in enumerate((m22, m14)):
            tmpl = model.init(torch.Generator().manual_seed(9))
            p, o, step = ckpt.restore(d[i], i + 1, tmpl,
                                      optim.init_opt_state(tmpl), mesh=mesh)
            specs = shd.params_sharding(p, mesh, "train")
            placed = all(tuple(q.placements)
                         == tuple(shd.placements(specs[n], mesh))
                         and tuple(o["m"][n].placements) == tuple(q.placements)
                         for n, q in p.named_parameters())
            got = ckpt._train_arrays(p, o)
            same = rank != 0 or (got.keys() == want.keys() and all(
                torch.equal(got[k], want[k]) for k in want))
            res[i] = (step, placed, same)
            ckpt.save(d[i + 1], i + 2, p, o)       # sharded: gathered
        tmpl = model.init(torch.Generator().manual_seed(9))
        p, o, step = ckpt.restore(d[2], 3, tmpl, optim.init_opt_state(tmpl))
        got = ckpt._train_arrays(p, o)
        res["one"] = (step, all(torch.equal(got[k], want[k]) for k in want))
        return res

    for name, fn in (("psum", psum), ("iterate", iterate),
                     ("resume", resume), ("elastic", elastic)):
        try:
            out[name] = fn()
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    if rank == 0:
        with open(outp, "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(run, args=(port, sys.argv[1], sys.argv[2]), nprocs=4)
'''

_JAX = r'''
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.parallel import compression

grads = pickle.load(open(sys.argv[1], "rb"))["grads"]
mesh = make_mesh((4,), ("dp",))
stacked = {k: jnp.stack([g[k] for g in grads]) for k in grads[0]}
out = {}
for method in ("none", "bf16", "int8"):
    def f(t):
        t = {k: v[0] for k, v in t.items()}
        r = compression.compressed_psum(t, "dp", method,
                                        key=jax.random.PRNGKey(0))
        return {k: v[None] for k, v in r.items()}
    res = shard_map(f, mesh=mesh, in_specs=({k: P("dp") for k in stacked},),
                    out_specs={k: P("dp") for k in stacked})(stacked)
    out[method] = {k: np.asarray(v) for k, v in res.items()}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, JAX's `shard_map` reductions by method)."""
    tmp = tmp_path_factory.mktemp("parallel")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"grads": _grads(), "tmp": str(tmp)}, f)
    (tmp / "ranks.py").write_text(textwrap.dedent(_RANKS))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "ranks.py"), str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "in.pkl"),
         str(tmp / "jax.pkl")],
        env={**env, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                          "--xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return got, ref


def _result(runs, name):
    out = runs[0][name]
    assert not (isinstance(out, dict) and "error" in out), out.get("error")
    return out


def _int8_bound(key):
    """Per element, the int8 reduction's bound against the exact mean:
    mean_i(127·|s̄ − s_i| + s_i) of each row's scales s_i (the mean scale
    decodes every rank's values), and mean_i s_i for the exact decode."""
    gs = [g[key].reshape(-1, g[key].shape[-1]) if g[key].ndim > 1
          else g[key][None] for g in _grads()]
    s = np.stack([np.abs(g).max(axis=-1) / 127.0 for g in gs])   # (4, rows)
    approx = (127 * np.abs(s.mean(0) - s) + s).mean(0)[:, None]
    exact = s.mean(0)[:, None]
    shape = _grads()[0][key].shape
    return (np.broadcast_to(approx, gs[0].shape).reshape(shape),
            np.broadcast_to(exact, gs[0].shape).reshape(shape))


@pytest.mark.parametrize("method", ["none", "bf16", "int8", "exact"])
def test_compressed_psum_on_four_ranks(runs, method):
    got = _result(runs, "psum")[method]
    ref = runs[1]
    mean = {k: np.mean([g[k] for g in _grads()], axis=0)
            for k in _grads()[0]}
    for k, want in mean.items():
        scale = float(np.abs(want).max())
        if method == "none":
            np.testing.assert_allclose(got[k], ref["none"][k][0], rtol=1e-6,
                                       atol=1e-6 * scale)
            np.testing.assert_allclose(got[k], want, rtol=1e-6,
                                       atol=1e-6 * scale)
        elif method == "bf16":
            # four bf16 payloads summed in bf16: a rounding of each and
            # of each partial sum, whatever the order
            lim = 4 * 2.0 ** -8 * float(np.abs(np.stack(
                [g[k] for g in _grads()])).sum(0).max())
            assert float(np.abs(got[k] - ref["bf16"][k][0]).max()) <= lim
        else:
            approx, exact = _int8_bound(k)
            bound = approx if method == "int8" else exact
            assert bool((np.abs(got[k] - want) <= bound + 1e-6).all())
            if method == "int8":
                assert bool((np.abs(ref["int8"][k][0] - want)
                             <= bound + 1e-6).all())


def test_iterator_yields_each_ranks_rows(runs):
    from repro_torch.data import synthetic
    cfg = treg.reduced_config(treg.get_config("whisper-medium"))
    got = _result(runs, "iterate")
    for i, step in enumerate((2, 3)):
        want = synthetic.lm_batch(cfg, 3, step, 4, 8)
        assert set(got[i]) == set(want) == {"tokens", "frames"}
        for k, (local, full, placements, shape) in got[i].items():
            np.testing.assert_array_equal(full, want[k])
            np.testing.assert_array_equal(local, want[k][:2])   # rank 0
            assert shape == want[k].shape
            assert placements == [("Shard", 0), ("Replicate", None)]


def test_fit_on_a_mesh_resumes_bit_for_bit(runs):
    out = _result(runs, "resume")
    assert out["latest"] == 4
    assert out["steps"] == [2, 3]
    assert out["losses"][0] == out["losses"][1]
    assert out["same"]


def test_elastic_restore_bit_for_bit(runs):
    """One device -> (2, 2) -> (1, 4) -> one device: every leaf of the
    parameters and the optimizer state equal bit for bit, and placed by
    the current mesh's rules."""
    out = _result(runs, "elastic")
    assert out[0] == (1, True, True)
    assert out[1] == (2, True, True)
    assert out["one"] == (3, True)


def test_train_launcher_on_a_mesh_under_torchrun():
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "16", "--mesh", "2,2"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if "[train] done" in ln]
    assert len(lines) == 1, res.stdout          # rank 0 only
    assert "over 2 steps on mesh {'data': 2, 'model': 2} (cpu)" in lines[0]
