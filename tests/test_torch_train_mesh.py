"""The port's LM train step on a device mesh (`make_train_step(mesh=)`)
against its one-device step and the JAX package's (2, 2) step.

Four gloo ranks on the CPU run every case of the file once, in one
subprocess (`ranks`): each rank joins a (2, 2) ("data", "model")
`DeviceMesh` (`launch/mesh.py::make_device_mesh`) and a (1, 4) one, and
steps each reduced config in fp32 from the JAX package's parameters
(`model.init(PRNGKey(0))`, carried over by `models/convert.py`) on the
same `lm_batch` (4 x 16). Rank 0 also runs the one-device step. The JAX
side runs in two subprocesses with four forced host devices
(`reference`), each stepping half of the configurations on a JAX (2, 2)
mesh (`repro.train.loop.make_train_step`, remat "none").

Held, for every one of the ten configurations on (2, 2) and for six on
(1, 4): the mesh step's loss and grad norm within 1e-5 of the
one-device step's and of JAX's (2, 2) step's; every gradient within 1e-5
of its leaf's largest of the one-device gradient; the updated parameters
within 1e-5 + 1e-5·|want| of both, plus the Adam conditioning allowance
`test_torch_train.py::test_train_step_matches_jax` states (a gradient
within a few eps of zero moves its parameter by up to lr·2 for a
gradient difference at the tolerance; fewer than 1 in 100 such elements);
each parameter's and optimizer state's placements equal the rule table's
(`parallel/sharding.py`). Also on (2, 2): two microbatches, two in
bfloat16 accumulation (gradients equal but for under 1 in 100 elements
rounded a bf16 step apart, whose parameters get Adam's capped allowance)
and a `clip_norm` that bites, each against the one-device step with the
same settings; and the three `remat` modes agree (loss and gradients, as
`test_remat_modes_agree` holds them on one device). On a (2, 1, 2)
("pod", "data", "model") mesh, the production pod mesh's axes, reduced
tinyllama's step is held to the one-device step as the (2, 2) steps are:
the batch splits over ("pod", "data") and the loss's mean and the
gradients' sums cover "pod" as well as "data". The launcher trains on
that mesh under torchrun (`--mesh 2,1,2`) and `--multi-pod` refuses a
world that is not 512. The `cuda` cases step
reduced models on a (1, 1) NCCL mesh on the card against the CPU, with
the planned kernel launches, and run the codec there.
"""

import dataclasses
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

from repro.configs import registry as jreg
from repro.data import synthetic as jsynthetic
from repro.models import api as japi

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["tinyllama-1.1b", "recurrentgemma-9b", "gemma3-27b", "olmo-1b",
         "yi-34b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
         "mamba2-1.3b", "whisper-medium", "qwen2-vl-72b"]
ARCHS_1X4 = ["tinyllama-1.1b", "recurrentgemma-9b", "granite-moe-3b-a800m",
             "mamba2-1.3b", "whisper-medium", "qwen2-vl-72b"]
B, T = 4, 16
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=20)
TOL = 1e-5
EPS = 1e-8                                   # OptConfig().eps
BF16_REL = 2.0 ** -7
# (name, arch, microbatches, grad_dtype, clip_norm)
EXTRAS = [("mb2", "tinyllama-1.1b", 2, "float32", 1.0),
          ("mb2_bf16", "tinyllama-1.1b", 2, "bfloat16", 1.0),
          ("clip", "granite-moe-3b-a800m", 1, "float32", 0.05)]
REMAT_ARCHS = ["tinyllama-1.1b", "recurrentgemma-9b"]
# the ("pod", "data", "model") mesh of shape (2, 1, 2)
POD_ARCHS = ["tinyllama-1.1b"]
# sequence parallelism (`activation_rules(..., seq_shard=True)`)
SP_ARCHS = ["tinyllama-1.1b", "recurrentgemma-9b", "mamba2-1.3b",
            "granite-moe-3b-a800m", "gemma3-27b", "whisper-medium"]
# a config whose 6 query heads do not divide 4 model ranks (yi-34b's 56
# heads on 16), so attention is not tensor-parallel on (1, 4)
H6 = ("yi-34b-h6", "yi-34b", dict(n_heads=6, n_kv_heads=2, head_dim=16))
T_ODD = 15                                   # 2 does not divide it
CASES = ([{"kind": "step", "key": f"2x2/{a}", "mesh": "2x2", "arch": a,
           "mb": 1, "grad_dtype": "float32", "clip": 1.0} for a in ARCHS]
         + [{"kind": "step", "key": f"1x4/{a}", "mesh": "1x4", "arch": a,
             "mb": 1, "grad_dtype": "float32", "clip": 1.0}
            for a in ARCHS_1X4]
         + [{"kind": "step", "key": f"extra/{n}", "mesh": "2x2", "arch": a,
             "mb": mb, "grad_dtype": gd, "clip": c}
            for n, a, mb, gd, c in EXTRAS]
         + [{"kind": "remat", "key": f"remat/{a}", "mesh": "2x2", "arch": a}
            for a in REMAT_ARCHS]
         + [{"kind": "step", "key": f"2x1x2/{a}", "mesh": "2x1x2", "arch": a,
             "mb": 1, "grad_dtype": "float32", "clip": 1.0}
            for a in POD_ARCHS]
         + [{"kind": "step", "key": f"sp/2x2/{a}", "mesh": "2x2", "arch": a,
             "mb": 1, "grad_dtype": "float32", "clip": 1.0, "one": False,
             "sp": [True]} for a in SP_ARCHS]
         + [{"kind": "step", "key": f"sp/1x4/{H6[0]}", "mesh": "1x4",
             "arch": H6[1], "over": H6[2], "pkey": H6[0], "mb": 1,
             "grad_dtype": "float32", "clip": 1.0, "sp": [False, True]},
            {"kind": "step", "key": f"sp/2x2/t{T_ODD}", "mesh": "2x2",
             "arch": "tinyllama-1.1b", "t": T_ODD, "mb": 1,
             "grad_dtype": "float32", "clip": 1.0, "one": False,
             "sp": [False, True]},
            {"kind": "prefill", "key": "sp/prefill", "mesh": "2x2",
             "arch": "recurrentgemma-9b", "t": T_ODD}])
# the JAX package's seq_shard steps on (2, 2): (key, arch, overrides)
SP_JAX = [(a, a, {}) for a in SP_ARCHS] + [H6]

_RANKS = r'''
import copy, dataclasses, datetime, os, pickle, socket, sys, traceback
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, port, inp, outp):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=300))
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import api, convert
    from repro_torch.parallel import policy, sharding as shd
    from repro_torch.train import loop, optim

    meshes = {"2x2": make_device_mesh((2, 2), ("data", "model"),
                                      device_type="cpu"),
              "1x4": init_device_mesh("cpu", (1, 4),
                                      mesh_dim_names=("data", "model")),
              "2x1x2": init_device_mesh("cpu", (2, 1, 2),
                                        mesh_dim_names=("pod", "data",
                                                        "model"))}
    data = pickle.load(open(inp, "rb"))
    seen = {}
    real_update = optim.apply_updates

    def spy(cfg, params, opt_state, grads):
        seen["grads"] = [g.full_tensor() if shd.is_distributed(g) else g
                         for g in grads]
        return real_update(cfg, params, opt_state, grads)

    optim.apply_updates = spy

    def np_list(ts):
        return [t.detach().float().numpy().copy() for t in ts]

    def setup(case):
        reg = registry
        cfg = dataclasses.replace(
            reg.reduced_config(reg.get_config(case["arch"])),
            dtype="float32", param_dtype="float32", **case.get("over", {}))
        model = api.build(cfg, device="cpu")
        base = convert.params_from_numpy(
            cfg, data["params"][case.get("pkey", case["arch"])], "cpu")
        batch = {k: torch.from_numpy(v)
                 for k, v in data["batches"][case["arch"]].items()}
        if "t" in case:
            batch["tokens"] = batch["tokens"][:, :case["t"]].contiguous()
        return cfg, model, base, batch

    def step_case(case):
        cfg, model, base, batch = setup(case)
        mesh = meshes[case["mesh"]]
        oc = optim.OptConfig(**data["opt"], clip_norm=case["clip"])
        kw = dict(microbatches=case["mb"], remat="full",
                  grad_dtype=case["grad_dtype"])
        out = {"names": [n for n, _ in base.named_parameters()],
               "batch_axes": shd.batch_sharding(mesh, len(batch["tokens"]))}
        if rank == 0 and case.get("one", True):
            p1 = copy.deepcopy(base)
            s1 = loop.make_train_step(model, oc, **kw)
            p1, _, m1 = s1(p1, optim.init_opt_state(p1), batch)
            out.update(m1={k: float(v) for k, v in m1.items()},
                       p1=np_list(p1.parameters()), g1=np_list(seen["grads"]))
        for sp in case.get("sp", [False]):
            s2, (p_spec, o_spec) = loop.make_train_step(model, oc, mesh=mesh,
                                                        **kw)
            p2 = copy.deepcopy(base)
            # the caller's rules, as the dry-run sets them around a step
            with policy.activation_rules(
                    shd.batch_sharding(mesh, len(batch["tokens"])), mesh,
                    seq_shard=sp):
                p2, o2, m2 = s2(p2, optim.init_opt_state(p2), batch)
            g2 = np_list(seen["grads"])
            full = np_list([p.full_tensor() for p in p2.parameters()])
            # names whose parameter or optimizer-state placements are not
            # the rule table's
            misplaced = [
                n for n, p in p2.named_parameters()
                if tuple(p.placements) != tuple(shd.placements(p_spec[n],
                                                               mesh))
                or any(tuple(o2[k][n].placements) != tuple(p.placements)
                       for k in ("m", "v", "master"))]
            if not all(isinstance(pl, Replicate)
                       for pl in o2["step"].placements):
                misplaced.append("step")
            res = dict(m2={k: float(v) for k, v in m2.items()}, p2=full,
                       g2=g2, misplaced=misplaced,
                       step=int(o2["step"].full_tensor()),
                       spec=o_spec["step"] == shd.P()
                       and o_spec["m"] is p_spec)
            out.update(res) if not sp else out.update(sp=res)
        return out

    def prefill_case(case):
        cfg, model, base, batch = setup(case)
        mesh = meshes[case["mesh"]]
        out = {}
        for sp in (False, True):
            params = shd.distribute(copy.deepcopy(base), mesh, "serve")
            with policy.activation_rules(
                    shd.batch_sharding(mesh, len(batch["tokens"])), mesh,
                    seq_shard=sp), torch.no_grad():
                logits, cache = model.prefill(
                    params, loop.shard_batch(batch, mesh),
                    max_len=case["t"] + 4)
            out[sp] = np_list([logits] + [v for c in cache
                                          for v in c.values()])
        return out

    def remat_case(case):
        cfg, model, base, batch = setup(case)
        mesh = meshes[case["mesh"]]
        params = shd.distribute(base, mesh, "train")
        params.requires_grad_(True)
        dbatch = loop.shard_batch(batch, mesh)
        out = {}
        for remat in ("none", "full", "dots"):
            loss = model.loss(params, dbatch, remat=remat)
            grads = torch.autograd.grad(loss, list(params.parameters()))
            out[remat] = [float(loss)] + np_list(
                [g.full_tensor() for g in loop._pin_grads(grads, params)])
        return out

    out = {}
    for case in data["cases"]:
        try:
            fn = {"step": step_case, "remat": remat_case,
                  "prefill": prefill_case}[case["kind"]]
            out[case["key"]] = fn(case)
        except Exception:
            out[case["key"]] = {"error": traceback.format_exc()}
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
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import registry
from repro.launch.mesh import make_mesh
from repro.models import api
from repro.parallel import policy, sharding as shd
from repro.train import loop, optim

data = pickle.load(open(sys.argv[1], "rb"))
half = int(sys.argv[3])
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
runs = ([(a, a, {}, False) for a in data["archs"][half::2]]
        + [(f"sp/{k}", a, over, True)
           for k, a, over in data["sp_jax"][half::2]])
for key, arch, over, sp in runs:
    cfg = dataclasses.replace(
        registry.reduced_config(registry.get_config(arch)),
        dtype="float32", param_dtype="float32", **over)
    model = api.build(cfg)
    params = jax.tree.map(jnp.asarray,
                          data["params"][key.removeprefix("sp/")])
    batch = {k: jnp.asarray(v) for k, v in data["batches"][arch].items()}
    oc = optim.OptConfig(**data["opt"])
    _, jit_for, (p_shard, o_shard) = loop.make_train_step(
        model, mesh, oc, remat="none", donate=False)
    step = jit_for(jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch))
    p = jax.device_put(params, p_shard)
    o = jax.device_put(optim.init_opt_state(params), o_shard)
    with mesh, policy.activation_rules(shd.batch_sharding(mesh, len(
            batch["tokens"])), seq_shard=sp):
        p1, _, met = step(p, o, batch)
    out[key] = {"params": jax.tree.map(np.asarray, p1),
                "metrics": {k: float(v) for k, v in met.items()}}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
'''


def _jax_inputs():
    """The JAX package's parameters and a batch of each config (and the
    parameters of `H6`), as numpy."""
    params, batches = {}, {}
    for key, arch, over in [(a, a, {}) for a in ARCHS] + [H6]:
        cfg = jax_cfg(arch, **over)
        params[key] = jax.tree.map(np.asarray, japi.build(cfg).init(
            jax.random.PRNGKey(0)))
        if key == arch:
            batches[arch] = jsynthetic.lm_batch(cfg, 0, 0, B, T)
    return params, batches


def jax_cfg(arch, **over):
    import dataclasses
    return dataclasses.replace(jreg.reduced_config(jreg.get_config(arch)),
                               dtype="float32", param_dtype="float32",
                               **over)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results by case key, JAX's (2, 2) steps by arch, the
    inputs)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    params, batches = _jax_inputs()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"params": params, "batches": batches, "opt": OPT,
                     "cases": CASES, "archs": ARCHS, "sp_jax": SP_JAX}, f)
    (tmp / "ranks.py").write_text(textwrap.dedent(_RANKS))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    ranks = subprocess.Popen(
        [sys.executable, str(tmp / "ranks.py"), str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    jenv = {**env, "JAX_PLATFORMS": "cpu",
            # one thread: the suite's other workers share the cores
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1"}
    halves = (0, 1)
    refs = [subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "in.pkl"),
         str(tmp / f"jax{i}.pkl"), str(i)], env=jenv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in halves]
    try:
        outs = [p.communicate(timeout=900) for p in [ranks] + refs]
    finally:
        for p in [ranks] + refs:
            p.kill()
    for p, (_, err) in zip([ranks] + refs, outs):
        assert p.returncode == 0, err[-3000:]
    ref = {}
    for i in halves:
        with open(tmp / f"jax{i}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    with open(tmp / "out.pkl", "rb") as f:
        got = pickle.load(f)
    return got, ref, params


def _case(runs, key):
    out = runs[0][key]
    assert "error" not in out, out.get("error")
    return out


def _port_order(arch, tree, **over):
    """A JAX param tree (numpy) as the port's parameter list."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import convert
    import dataclasses
    cfg = dataclasses.replace(treg.reduced_config(treg.get_config(arch)),
                              dtype="float32", param_dtype="float32",
                              **over)
    return [p.detach().numpy() for p in convert.params_from_numpy(
        cfg, tree, "cpu").parameters()]


def _adam_close(got, want, grads, lr, clip, differ=None):
    """Each parameter within TOL + TOL·|want| plus lr times Adam's
    conditioning allowance for a gradient difference of TOL of the leaf's
    largest (lr·2, the cap, where `differ` marks a gradient element the
    two runs rounded apart); fewer than 1 in 100 elements lean on the
    allowance."""
    loose = total = 0
    for i, (g, w, gr) in enumerate(zip(got, want, grads)):
        gr = clip * gr
        delta = TOL * float(np.abs(gr).max())
        cond = np.where(gr == 0, 0.0, np.minimum(2.0, delta * EPS / (
            np.maximum(np.abs(gr) - delta, 0.0) + EPS) ** 2))
        if differ is not None:
            cond = np.where(differ[i], 2.0, cond)
        assert bool((np.abs(g - w) <= TOL + TOL * np.abs(w)
                     + lr * cond).all())
        loose += int((lr * cond > TOL).sum())
        total += gr.size
    assert loose < 1e-2 * total


def _hold_to_one_device(out, bf16=False):
    """Metrics within TOL; each gradient within TOL of its leaf's largest
    (bf16 accumulation: equal but for under 1 in 100 elements rounded a
    bf16 step of the leaf's largest apart); parameters by `_adam_close`."""
    m1, m2 = out["m1"], out["m2"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(m2[k], m1[k], rtol=TOL)
    differ = None
    if bf16:
        differ = [a != b for a, b in zip(out["g2"], out["g1"])]
        assert sum(int(d.sum()) for d in differ) < 1e-2 * sum(
            d.size for d in differ)
    for a, b in zip(out["g2"], out["g1"]):
        assert a.shape == b.shape
        rel = BF16_REL if bf16 else TOL
        assert float(np.abs(a - b).max()) <= rel * max(
            float(np.abs(b).max()), 1e-30)
    clip = min(1.0, out.get("clip", 1.0) / m1["grad_norm"])
    _adam_close(out["p2"], out["p1"], out["g1"], m1["lr"], clip, differ)
    assert out["misplaced"] == []
    assert out["spec"] and out["step"] == 1


@pytest.mark.parametrize("mesh,arch", [("2x2", a) for a in ARCHS]
                         + [("1x4", a) for a in ARCHS_1X4])
def test_mesh_step_matches_one_device_and_jax(runs, mesh, arch):
    """One `make_train_step(mesh=)` step: against the one-device step and
    JAX's (2, 2) step (module docstring)."""
    out = _case(runs, f"{mesh}/{arch}")
    _hold_to_one_device(out)
    ref = runs[1][arch]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(out["m2"][k], ref["metrics"][k],
                                   rtol=TOL)
    clip = min(1.0, 1.0 / out["m1"]["grad_norm"])
    _adam_close(out["p2"], _port_order(arch, ref["params"]), out["g1"],
                out["m1"]["lr"], clip)


@pytest.mark.parametrize("arch", POD_ARCHS)
def test_pod_mesh_step_matches_one_device(runs, arch):
    """One step on the (2, 1, 2) ("pod", "data", "model") mesh: the batch
    split over ("pod", "data"), and the step within the file's rule of
    the one-device step (a loss mean or a gradient sum over "data" alone
    would be off by the pod axis's share)."""
    out = _case(runs, f"2x1x2/{arch}")
    assert out["batch_axes"] == ("pod", "data")
    _hold_to_one_device(out)
    base = _case(runs, f"2x2/{arch}")
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(out["m2"][k], base["m2"][k], rtol=TOL)


def test_train_launcher_on_a_pod_mesh_under_torchrun():
    """`launch/train.py --mesh 2,1,2` under torchrun (four gloo ranks):
    trains on the ("pod", "data", "model") mesh and names it."""
    import socket

    with socket.socket() as s:            # a free port, not torchrun's
        s.bind(("127.0.0.1", 0))          # default, which another test's
        port = s.getsockname()[1]         # torchrun may hold
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "16", "--mesh", "2,1,2"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if "[train] done" in ln]
    assert len(lines) == 1, res.stdout          # rank 0 only
    assert ("over 2 steps on mesh {'pod': 2, 'data': 1, 'model': 2} (cpu)"
            in lines[0])


@pytest.mark.parametrize("world", [None, "4", "256"])
def test_multi_pod_refuses_a_world_that_is_not_512(world, monkeypatch,
                                                   capsys):
    """`--multi-pod` trains on the (2, 16, 16) production mesh only: any
    other world is refused before a process group or a model is made."""
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train

    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--arch", "tinyllama-1.1b", "--smoke",
                           "--device", "cpu", "--multi-pod"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "512" in err and f"WORLD_SIZE is {world or 1}" in err
    assert not dist.is_initialized()
    from repro_torch.launch.mesh import production_shape
    assert production_shape(multi_pod=True) == ((2, 16, 16),
                                                ("pod", "data", "model"))


@pytest.mark.parametrize("name", [e[0] for e in EXTRAS])
def test_mesh_step_options_match_one_device(runs, name):
    """Two microbatches (the JAX reshape's: rows [i·B/2, (i+1)·B/2) of the
    global batch, each split over "data"), their bfloat16 accumulation
    (held within bf16's rounding of the gradients) and a biting
    `clip_norm`, each against the one-device step with the same
    settings."""
    _, arch, mb, grad_dtype, clip = next(e for e in EXTRAS if e[0] == name)
    out = dict(_case(runs, f"extra/{name}"), clip=clip)
    if name == "clip":
        assert out["m1"]["grad_norm"] > 10 * clip      # the clip bites
    _hold_to_one_device(out, bf16=grad_dtype == "bfloat16")


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_mesh_remat_modes_agree(runs, arch):
    """On (2, 2), `remat` "full" (the blocks' weight gathers recomputed in
    the backward) and "dots" (a selective checkpoint over the gathers'
    collectives) give the loss and gradients of "none"."""
    out = _case(runs, f"remat/{arch}")
    base = out["none"]
    for remat in ("full", "dots"):
        for a, b in zip(out[remat], base):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _hold_sp(sp, base):
    """A `seq_shard` mesh step against the same step without it: metrics
    within TOL, each gradient within TOL of its leaf's largest, the
    updated parameters by `_adam_close`, the placements the rule
    table's."""
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(sp["m2"][k], base["m2"][k], rtol=TOL)
    for a, b in zip(sp["g2"], base["g2"]):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= TOL * max(
            float(np.abs(b).max()), 1e-30)
    clip = min(1.0, 1.0 / base["m2"]["grad_norm"])
    _adam_close(sp["p2"], base["p2"], base["g2"], base["m2"]["lr"], clip)
    assert sp["misplaced"] == []
    assert sp["spec"] and sp["step"] == 1


@pytest.mark.parametrize("mesh,arch", [("2x2", a) for a in SP_ARCHS]
                         + [("1x4", H6[0])])
def test_seq_shard_step_matches_non_sp_and_jax(runs, mesh, arch):
    """One `make_train_step(mesh=)` step under `activation_rules(...,
    seq_shard=True)` against the same mesh step without it and against
    the JAX package's (2, 2) step under `seq_shard=True` (the file's
    rule). whisper has no T-sharded section: bit for bit its step
    without it. On (1, 4) the H6 config's attention is not
    tensor-parallel (it runs whole between the T gather and the slice),
    and its step without `seq_shard` is also held to one device."""
    from repro_torch.configs import registry as treg
    from repro_torch.parallel import policy

    out = _case(runs, f"sp/{mesh}/{arch}")
    over = {}
    if arch == H6[0]:
        _, jarch, over = H6
        cfg = dataclasses.replace(treg.reduced_config(treg.get_config(
            jarch)), **over)
        assert not policy._attn_tp(cfg, 4)
        base = out
        _hold_to_one_device(base)
    else:
        jarch, base = arch, _case(runs, f"{mesh}/{arch}")
    sp = out["sp"]
    if arch == "whisper-medium":
        assert sp["m2"] == base["m2"]
        for a, b in zip(sp["p2"] + sp["g2"], base["p2"] + base["g2"]):
            assert np.array_equal(a, b)
    _hold_sp(sp, base)
    ref = runs[1][f"sp/{arch}"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(sp["m2"][k], ref["metrics"][k], rtol=TOL)
    clip = min(1.0, 1.0 / base["m1"]["grad_norm"])
    _adam_close(sp["p2"], _port_order(jarch, ref["params"], **over),
                base["g1"], base["m1"]["lr"], clip)


def test_seq_shard_at_a_t_the_model_axis_does_not_divide(runs):
    """T = 15 on (2, 2): the slices pad T to 16 and the gathers crop it
    (no fallback to the whole T); the step equals the step without
    `seq_shard` at the same T."""
    out = _case(runs, f"sp/2x2/t{T_ODD}")
    _hold_sp(out["sp"], out)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-27b"])
def test_seq_shard_norm_scale_gradients(runs, arch):
    """Every norm scale (`norm1`, `norm2`, gemma3's `post1`/`post2`,
    `final_norm`) is used whole by each model rank on its own slice of T,
    so its gradient sums over "model" ("partial" use): equal to its
    gradient without `seq_shard`, not a model rank's share of it."""
    out = _case(runs, f"sp/2x2/{arch}")
    base = _case(runs, f"2x2/{arch}")
    leaves = [i for i, n in enumerate(out["names"])
              if "norm" in n or "post" in n]
    assert len(leaves) >= 2 * 2 + 1
    for i in leaves:
        got, want = out["sp"]["g2"][i], base["g2"][i]
        assert float(np.abs(want).max()) > 0
        assert abs(float(got.sum()) - float(want.sum())) <= TOL * float(
            np.abs(want).sum())
        assert float(np.abs(got - want).max()) <= TOL * float(
            np.abs(want).max())


def test_seq_shard_prefill_equals_non_sp(runs):
    """`Model.prefill` of recurrentgemma's reduced config (recurrent and
    attention layers) at T = 15 on the gloo (2, 2) mesh: the logits and
    every cache entry under `seq_shard` equal those without it (a
    two-rank reduce-scatter adds what the all-reduce adds)."""
    out = _case(runs, "sp/prefill")
    assert len(out[True]) == len(out[False]) > 1
    assert out[True][0].shape == (B // 2, T_ODD, out[False][0].shape[-1])
    for a, b in zip(out[True], out[False]):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _card_mesh():
    """A (1, 1) mesh on the card: NCCL, a world of one (made once a
    process, then reused)."""
    from repro_torch.launch.mesh import make_device_mesh
    return make_device_mesh((1, 1), ("data", "model"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m", "mamba2-1.3b",
                                  "whisper-medium"])
def test_cuda_mesh_step_matches_the_cpu(arch, cuda):
    """One fp32 step of the reduced model on a (1, 1) mesh on the card
    (the flash, LRU and xent kernels on each rank's local tensors, remat
    "full") against the one-device step on the CPU: loss, grad norm and
    updated parameters within 1e-4, the planned launches a step."""
    import copy
    import dataclasses

    from repro_torch.configs import registry as treg
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.models import api, lm
    from repro_torch.train import loop, optim

    cfg = dataclasses.replace(treg.reduced_config(treg.get_config(arch)),
                              dtype="float32", param_dtype="float32")
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic.lm_batch(cfg, 0, 0, 2, 33).items()}
    params = api.build(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    oc = optim.OptConfig(lr=1e-3)
    p1 = copy.deepcopy(params)
    p1, _, m1 = loop.make_train_step(api.build(cfg, device="cpu"), oc)(
        p1, optim.init_opt_state(p1), batch)
    step, _ = loop.make_train_step(api.build(cfg, device=cuda), oc,
                                   mesh=_card_mesh())
    p2 = copy.deepcopy(params).to(cuda)
    _build.reset_launches()
    p2, _, m2 = step(p2, optim.init_opt_state(p2),
                     {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for k in ("loss", "grad_norm"):
        assert abs(float(m2[k]) - float(m1[k])) <= 1e-4 * abs(float(m1[k]))
    for a, b in zip(p1.parameters(), p2.parameters()):
        assert float((a.detach() - b.full_tensor().cpu()).abs().max()) <= 1e-4
    assert launches["xent"] == 1
    if cfg.encdec:
        assert launches["flash_attn"] == (cfg.encdec.encoder_layers
                                          + cfg.n_layers)
        return
    kinds = lm.layer_kinds(cfg)
    recomputed = kinds[:cfg.n_repeats * len(cfg.pattern)]
    assert launches["flash_attn"] == sum(
        k not in ("rec", "ssd") for k in kinds + recomputed)
    assert launches["lru_scan"] == 2 * kinds.count("rec") + sum(
        k == "rec" for k in recomputed)


@pytest.mark.cuda
def test_cuda_codec_on_the_card(cuda):
    """The int8 codec's bound on the card, and every `compressed_psum`
    method over the (1, 1) mesh's "data" axis returning the input within
    its rounding."""
    from repro_torch.parallel import compression

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(64, 256, generator=gen, device=cuda)
    q, s = compression.int8_rowwise_encode(x, gen)
    assert bool(((compression.int8_rowwise_decode(q, s) - x).abs()
                 <= s + 1e-6).all())
    mesh = _card_mesh()
    for method, lim in (("none", 0.0), ("bf16", 2.0 ** -8),
                        ("int8", None)):
        out = compression.compressed_psum({"x": x}, mesh, "data", method,
                                          generator=gen)["x"]
        err = (out - x).abs()
        bound = s + 1e-6 if lim is None else lim * x.abs() + 1e-30
        assert bool((err <= bound).all()), method
