"""PyTorch port of the Mamba2 SSD mixer (`models/ssd.py`) against the JAX
package.

The same parameters (`repro.models.ssd.ssd_init`, as numpy) and seeded
activations go through both packages' `ssd_apply`: T a multiple of the
chunk and not (the left pad), and decode steps from a prefilled state.
Outputs and states within 1e-5 of their largest magnitude. The chunked
scan is also held against a step-by-step recurrence, the JAX package's own
check (`tests/test_models_equivalence.py:79`), at its 2e-4.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import ssd as jssd
from repro_torch.configs import registry as treg
from repro_torch.models import ssd

TOL = 1e-5


def _configs():
    return [dataclasses.replace(reg.reduced_config(
        reg.get_config("mamba2-1.3b")), dtype="float32",
        param_dtype="float32") for reg in (jreg, treg)]


def _params(jcfg, seed=0):
    jp = jssd.ssd_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # a spread of decays and skip weights, not the init's constants
    rng = np.random.default_rng(seed)
    nh = jp["A_log"].shape[0]
    jp = dict(jp, D=jnp.asarray(rng.normal(size=nh).astype(np.float32)),
              dt_bias=jnp.asarray(rng.normal(size=nh).astype(np.float32)))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _sequential(x, dt, A, B, C, h0=None):
    """Step-by-step recurrence: h = exp(dt A) h + dt B x, y = C h."""
    b, t, h, p = x.shape
    rep = h // B.shape[2]
    Bh = np.repeat(B, rep, axis=2)
    Ch = np.repeat(C, rep, axis=2)
    hs = np.zeros((b, h, p, B.shape[-1])) if h0 is None else h0.copy()
    ys = np.zeros_like(x)
    for i in range(t):
        da = np.exp(dt[:, i] * A)
        hs = (hs * da[..., None, None] + dt[:, i, :, None, None]
              * Bh[:, i, :, None, :] * x[:, i, :, :, None])
        ys[:, i] = np.einsum("bhn,bhpn->bhp", Ch[:, i], hs)
    return ys, hs


def _scan_inputs(seed, t):
    rng = np.random.default_rng(seed)
    b, h, p, g, n = 2, 4, 8, 2, 8
    return (rng.normal(size=(b, t, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.5, size=(b, t, h)).astype(np.float32),
            -rng.uniform(0.1, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, t, g, n)).astype(np.float32),
            rng.normal(size=(b, t, g, n)).astype(np.float32))


@pytest.mark.parametrize("seed,t,chunk", [(0, 4, 4), (1, 8, 4), (2, 16, 8),
                                          (3, 16, 16), (4, 8, 8)])
def test_ssd_chunked_matches_sequential(seed, t, chunk):
    x, dt, A, B, C = _scan_inputs(seed, t)
    h0 = np.random.default_rng(seed + 10).normal(
        size=(2, 4, 8, 8)).astype(np.float32)
    for start in (None, h0):
        want_y, want_h = _sequential(x, dt, A, B, C, start)
        got_y, got_h = ssd._ssd_chunked(
            *map(torch.from_numpy, (x, dt, A, B, C)), chunk=chunk,
            h0=None if start is None else torch.from_numpy(start))
        np.testing.assert_allclose(got_y.numpy(), want_y, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got_h.numpy(), want_h, rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("t,chunk", [(16, 4), (16, 16), (12, 4)])
def test_ssd_chunked_matches_jax(t, chunk):
    x, dt, A, B, C = _scan_inputs(5, t)
    h0 = np.random.default_rng(6).normal(size=(2, 4, 8, 8)).astype(
        np.float32)
    want_y, want_h = jssd._ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                                       chunk, jnp.asarray(h0))
    got_y, got_h = ssd._ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)),
                                    chunk, torch.from_numpy(h0))
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_segsum_matches_jax(rng):
    x = rng.normal(size=(2, 3, 9)).astype(np.float32)
    want = np.asarray(jssd._segsum(jnp.asarray(x)))
    got = ssd._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t", [32, 21, 5])      # 2 chunks; left pad; T < 16
def test_ssd_apply_matches_jax(t, rng):
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    x = rng.normal(size=(2, t, tcfg.d_model)).astype(np.float32)
    want, wst = jssd.ssd_apply(jcfg, jp, jnp.asarray(x))
    got, gst = ssd.ssd_apply(tcfg, tp, torch.from_numpy(x))
    _close(got, want)
    for k in ("h", "conv"):
        _close(gst[k], wst[k])


def test_ssd_decode_from_prefill_matches_jax(rng):
    """A 16-token prefill, then three one-token steps each from the state
    the last left."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, seed=2)
    x = rng.normal(size=(2, 19, tcfg.d_model)).astype(np.float32)
    _, wst = jssd.ssd_apply(jcfg, jp, jnp.asarray(x[:, :16]))
    _, gst = ssd.ssd_apply(tcfg, tp, torch.from_numpy(x[:, :16]))
    for i in range(16, 19):
        want, wst = jssd.ssd_decode_step(jcfg, jp, jnp.asarray(x[:, i:i + 1]),
                                         wst)
        got, gst = ssd.ssd_decode_step(tcfg, tp,
                                       torch.from_numpy(x[:, i:i + 1]), gst)
        _close(got, want)
        for k in ("h", "conv"):
            _close(gst[k], wst[k])


def test_ssd_decode_equals_the_prefill():
    """The port against itself: a prefill's outputs equal one step at a
    time from a zero state."""
    _, tcfg = _configs()
    tp = ssd.ssd_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
    x = torch.randn((2, 9, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    want, _ = ssd.ssd_apply(tcfg, tp, x)
    st = ssd.ssd_init_state(tcfg, 2, torch.float32, "cpu")
    for i in range(9):
        got, st = ssd.ssd_decode_step(tcfg, tp, x[:, i:i + 1], st)
        _close(got.numpy(), want[:, i:i + 1].numpy(), 2e-4)


def test_ssd_padding_needs_a_fresh_state():
    _, tcfg = _configs()
    tp = ssd.ssd_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
    st = ssd.ssd_init_state(tcfg, 1, torch.float32, "cpu")
    with pytest.raises(ValueError, match="fresh state"):
        ssd.ssd_apply(tcfg, tp, torch.zeros((1, 21, tcfg.d_model)), st)


def test_ssd_init_and_state_shapes():
    jcfg, tcfg = _configs()
    jp = jssd.ssd_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = ssd.ssd_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    for k in ("A_log", "D", "dt_bias", "norm_scale"):     # linspace: 1 ulp
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=2e-7)
    jst = jssd.ssd_init_state(jcfg, 3, jnp.float32)
    tst = ssd.ssd_init_state(tcfg, 3, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tst.items()} == \
        {k: v.shape for k, v in jst.items()}
