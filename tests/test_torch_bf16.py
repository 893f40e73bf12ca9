"""bfloat16 training of the port against the JAX package's bfloat16.

A bf16 computation has no exact answer to hold another to, so both
packages are held to the same one: the JAX package's fp32 run from the
same parameters (the bf16 parameters upcast) and batches. On reduced
tinyllama and recurrentgemma in bf16 (the reduced configs' own dtypes),
from the same converted parameters, over the batches of `SEEDS`:

* the gradients of one loss: a run's error is its worst leaf's (a leaf's
  largest difference from the fp32 gradient over that leaf's largest
  fp32 magnitude); the port's, averaged over the seeds, is within
  `RATIO` times the JAX bf16 gradients' average;
* four `make_train_step` steps (the launcher's optimizer settings,
  remat "none"): a run's error is its largest loss difference from the
  fp32 run's; the port's average over the seeds is within `RATIO` times
  the JAX bf16 run's.

The average is over seeds because one seed's ratio is noise: Adam turns
the sign of a gradient within its rounding into a full step, and the
two packages round differently (eager PyTorch rounds every op's output
to bf16; XLA may keep an elementwise chain in fp32). Over eight seeds on
the CPU one seed's loss-curve ratio ran from 0.68 to 2.70 in either
package's favour, its average 1.18 (tinyllama) and 1.08
(recurrentgemma).
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.data import synthetic as jsynthetic
from repro.launch.mesh import make_mesh
from repro.models import api as japi
from repro.train import loop as jloop
from repro.train import optim as joptim
from repro_torch.configs import registry as treg
from repro_torch.models import api, convert
from repro_torch.train import loop, optim

ARCHS = ["tinyllama-1.1b", "recurrentgemma-9b"]
RATIO = 1.25
SEEDS = range(8)
STEPS = 4
B, T = 4, 16
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=20)


def _cfg(reg, arch, dtype):
    cfg = reg.reduced_config(reg.get_config(arch))
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
    return cfg


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """For each seed, the gradients of one loss and four steps' losses:
    the JAX package in fp32 and bf16, the port in bf16, from the same
    parameters: {run: [(grads, losses) a seed]}."""
    arch = request.param
    jb16, jf32 = (_cfg(jreg, arch, d) for d in ("bfloat16", "float32"))
    tb16, tf32 = (_cfg(treg, arch, d) for d in ("bfloat16", "float32"))
    assert jb16.dtype == jb16.param_dtype == "bfloat16"
    p16 = japi.build(jb16).init(jax.random.PRNGKey(0))
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32), p16)
    data = [[jsynthetic.lm_batch(jb16, seed, s, B, T) for s in range(STEPS)]
            for seed in SEEDS]
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    for name, cfg, params in (("jax_f32", jf32, p32),
                              ("jax_b16", jb16, p16)):
        m = japi.build(cfg)
        grad = jax.jit(jax.grad(lambda p, b: m.loss(p, b, remat="none")))
        step, _, _ = jloop.make_train_step(m, mesh, joptim.OptConfig(**OPT),
                                           remat="none")
        step = jax.jit(step)
        out[name] = []
        for batches in data:
            grads = grad(params, jax.tree.map(jnp.asarray, batches[0]))
            p, o, losses = params, joptim.init_opt_state(params), []
            for b in batches:
                p, o, met = step(p, o, jax.tree.map(jnp.asarray, b))
                losses.append(float(met["loss"]))
            out[name].append(([np.asarray(g, np.float32)
                               for g in jax.tree.leaves(grads)], losses))
    tm = api.build(tb16, device="cpu")
    tp = convert.params_from_numpy(tb16, jax.tree.map(np.asarray, p16),
                                   "cpu")
    # the gradients in fp32, as the JAX tree's leaves
    holder = convert.params_from_numpy(tf32, jax.tree.map(np.asarray, p32),
                                       "cpu")
    step = loop.make_train_step(tm, optim.OptConfig(**OPT), remat="none")
    out["port_b16"] = []
    for batches in data:
        probe = copy.deepcopy(tp).requires_grad_(True)
        tb = {k: torch.from_numpy(v) for k, v in batches[0].items()}
        grads = torch.autograd.grad(tm.loss(probe, tb, remat="none"),
                                    list(probe.parameters()))
        with torch.no_grad():
            for p, g in zip(holder.parameters(), grads):
                p.copy_(g.float())
        tgrads = [np.array(g) for g in jax.tree.leaves(
            convert.params_to_numpy(tf32, holder))]
        p, losses = copy.deepcopy(tp), []
        o = optim.init_opt_state(p)
        for b in batches:
            p, o, met = step(p, o, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            losses.append(float(met["loss"]))
        out["port_b16"].append((tgrads, losses))
    return arch, out


def _worst_leaf(grads, ref):
    return max(float(np.abs(g - r).max()) / max(float(np.abs(r).max()),
                                                 1e-30)
               for g, r in zip(grads, ref))


def _mean_errors(out, err):
    """(JAX bf16's, the port's) mean over the seeds of `err(run, ref)`."""
    ref = out["jax_f32"]
    return [float(np.mean([err(got, want) for got, want in zip(out[k], ref)]))
            for k in ("jax_b16", "port_b16")]


def test_bf16_gradients_within_the_jax_bf16_error(runs):
    arch, out = runs
    shapes = [g.shape for g in out["jax_f32"][0][0]]
    assert [g.shape for g in out["port_b16"][0][0]] == shapes
    jerr, terr = _mean_errors(out, lambda a, b: _worst_leaf(a[0], b[0]))
    assert 0 < jerr < 0.5
    assert terr <= RATIO * jerr, (arch, terr, jerr)


def test_bf16_loss_curve_within_the_jax_bf16_error(runs):
    arch, out = runs
    assert all(np.all(np.isfinite(r[1])) for r in out["port_b16"])
    jerr, terr = _mean_errors(out, lambda a, b: float(np.abs(
        np.asarray(a[1]) - np.asarray(b[1])).max()))
    assert 0 < jerr < 0.5
    assert terr <= RATIO * jerr, (arch, terr, jerr)
