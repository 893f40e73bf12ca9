"""PyTorch port of the MoE layer (`models/moe.py`) against the JAX package.

The same parameters (`repro.models.moe.moe_init`, as numpy) and the same
seeded activations go through both packages' `moe_apply`, with both
dispatches. The routing is compared first: each chunk's top-k expert
indices must be equal (a tie goes to the lower expert in both), so that
the overflow, which depends on token order inside a chunk, is the same.
Then the outputs, within 1e-5 of their largest magnitude, the aux term
within 1e-6, and the gradients within 5e-6 of each leaf's largest.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe

TOL = 1e-5
GRAD_TOL = 5e-6


def _configs(arch="granite-moe-3b-a800m", **moe_kw):
    """The reduced fp32 config in both packages, its MoE block changed by
    `moe_kw`."""
    out = []
    for reg, cls in ((jreg, JMoEConfig), (treg, MoEConfig)):
        cfg = reg.reduced_config(reg.get_config(arch))
        m = dataclasses.asdict(cfg.moe)
        m.update(moe_kw)
        out.append(dataclasses.replace(cfg, dtype="float32",
                                       param_dtype="float32", moe=cls(**m)))
    return out


def _params(jcfg, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _chunks(cfg, x):
    """x (B, T, D) as the layer's router chunks, padded as it pads."""
    chunk = min(cfg.moe.router_chunk, x.shape[0] * x.shape[1])
    xt = x.reshape(-1, x.shape[-1])
    pad = (-xt.shape[0]) % chunk
    xt = np.pad(xt, ((0, pad), (0, 0)))
    return chunk, xt.reshape(-1, chunk, xt.shape[-1])


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("impl", ["onehot", "gather"])
@pytest.mark.parametrize("capacity_factor,t", [
    (1.25, 16),        # the config's capacity
    (0.25, 16),        # small enough that tokens overflow
    (0.5, 40)])        # 80 tokens in chunks of 64: a padded chunk
def test_moe_apply_matches_jax(arch, impl, capacity_factor, t, rng):
    jcfg, tcfg = _configs(arch, impl=impl, capacity_factor=capacity_factor)
    jp, tp = _params(jcfg)
    x = rng.normal(size=(2, t, tcfg.d_model)).astype(np.float32)
    chunk, xc = _chunks(tcfg, x)
    cap = moe._capacity(chunk, tcfg)
    assert cap == jmoe._capacity(chunk, jcfg)
    dropped = 0
    for xs in xc:
        probs = jax.nn.softmax(jnp.asarray(xs) @ jp["router"], axis=-1)
        _, want_idx = jax.lax.top_k(probs, tcfg.moe.top_k)
        _, idx, pos, keep, _ = moe._route(tcfg, tp, torch.from_numpy(xs),
                                          cap)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        dropped += int((~keep).sum())
    if capacity_factor < 1:
        assert dropped > 0
    want, want_aux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    got, got_aux = moe.moe_apply(tcfg, tp, torch.from_numpy(x))
    _close(got, want)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("impl", ["onehot", "gather"])
def test_moe_grads_match_jax(impl, rng):
    """Gradients of a weighted sum of the output plus the aux term, with
    respect to the input and every parameter, with tokens overflowing."""
    jcfg, tcfg = _configs(impl=impl, capacity_factor=0.5)
    jp, tp = _params(jcfg, seed=1)
    x = rng.normal(size=(2, 16, tcfg.d_model)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(jcfg, p, xx)
        return jnp.sum(y * cot) + 3.0 * aux

    want = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [t.requires_grad_() for t in (*tp.values(), torch.from_numpy(x))]
    y, aux = moe.moe_apply(tcfg, dict(zip(tp, leaves)), leaves[-1])
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum() + 3.0 * aux,
                              leaves)
    for name, g in zip(list(tp) + ["x"], got):
        w = want[1] if name == "x" else want[0][name]
        _close(g, w, GRAD_TOL)


def test_ties_go_to_the_lower_expert():
    """Equal probabilities (a padded row's zero logits) pick experts in
    index order, as `jax.lax.top_k` does; the aux term counts them so."""
    _, tcfg = _configs()
    _, tp = _params(_configs()[0])
    xs = torch.zeros((3, tcfg.d_model))
    gate_vals, idx, pos, keep, _ = moe._route(tcfg, tp, xs, 4)
    assert idx.tolist() == [[0, 1]] * 3
    assert pos.tolist() == [[0, 0], [1, 1], [2, 2]]
    torch.testing.assert_close(gate_vals, torch.full((3, 2), 0.5))


@pytest.mark.parametrize("chunk", [1, 2, 7, 48, 64, 512])
def test_capacity_is_the_jax_packages(chunk):
    for arch in ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b"):
        jcfg, tcfg = (reg.get_config(arch) for reg in (jreg, treg))
        assert moe._capacity(chunk, tcfg) == jmoe._capacity(chunk, jcfg)


def test_moe_init_shapes_and_dtypes():
    """The JAX package's leaves: the router float32, the experts stacked
    in the parameter dtype."""
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = moe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape
        assert str(tp[k].dtype)[6:] == str(v.dtype)
