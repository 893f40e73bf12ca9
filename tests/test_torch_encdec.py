"""PyTorch port of the encoder-decoder (`models/encdec.py`) and the dense
attention its cross-attention uses, against the JAX package.

The reduced whisper config's parameters (`repro.models.api.build(cfg)
.init(PRNGKey(0))`, as numpy through `models.convert`) and the same seeded
frames and tokens go through both packages' `encode` and `decode`: the
encoder's states and the logits within 1e-5 of their largest magnitude.
`lm_batch`'s frames are the JAX package's element for element, and the
serving cache keeps the encoder's states unwritten.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.data import synthetic as jsynthetic
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro_torch.configs import registry as treg
from repro_torch.data import synthetic
from repro_torch.models import api, attention, convert, encdec

TOL = 1e-5
ARCH = "whisper-medium"


def _configs(dtype="float32"):
    return [dataclasses.replace(reg.reduced_config(reg.get_config(ARCH)),
                                dtype=dtype, param_dtype=dtype)
            for reg in (jreg, treg)]


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port params), the same values."""
    jcfg, tcfg = _configs()
    jp = japi.build(jcfg).init(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _close(got, want, tol=TOL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _batch(cfg, seed=0, t=17):
    return synthetic.lm_batch(cfg, seed, 0, 2, t)


def test_sinusoid_matches_jax():
    pos = np.broadcast_to(np.arange(40) + 7, (2, 40))
    for d in (16, 64, 1024):
        want = jencdec.sinusoid_at(jnp.asarray(pos), d)
        got = encdec.sinusoid_at(torch.from_numpy(pos.copy()), d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("t,s,h,kh,causal,window,q_offset,softcap", [
    (7, 32, 4, 4, False, 0, 0, 0.0),         # cross-attention
    (24, 24, 4, 2, True, 0, 0, 0.0),         # GQA, causal
    (1, 24, 4, 1, True, 0, 23, 0.0),         # one decode row
    (20, 20, 8, 2, True, 6, 0, 0.0),         # a window
    (9, 13, 4, 2, False, 0, 0, 30.0)])       # softcap
def test_dense_attention_matches_jax(t, s, h, kh, causal, window, q_offset,
                                     softcap, rng):
    q = rng.normal(size=(2, t, h, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, kh, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, kh, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              softcap=softcap)
    want = jattn.dense_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = attention.dense_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got, want)


def test_encode_matches_jax(pair):
    jcfg, jp, tcfg, tp = pair
    frames = _batch(tcfg)["frames"]
    want = jencdec.encode(jcfg, jp, jnp.asarray(frames))
    with torch.inference_mode():
        got = encdec.encode(tcfg, tp, torch.from_numpy(frames))
    _close(got, want)


def test_decode_matches_jax(pair):
    """The decoder in train mode, then prefill and three decode steps, each
    against the JAX package's, over the same encoder states."""
    jcfg, jp, tcfg, tp = pair
    b = _batch(tcfg, seed=3, t=20)
    enc = np.array(jencdec.encode(jcfg, jp, jnp.asarray(b["frames"])))
    toks = b["tokens"]
    jenc, tenc = jnp.asarray(enc), torch.from_numpy(enc)
    want, _ = jencdec.decode(jcfg, jp, jnp.asarray(toks), jenc)
    with torch.inference_mode():
        got, _ = encdec.decode(tcfg, tp, torch.from_numpy(toks), tenc)
    _close(got, want)
    jc = jencdec.init_cache(jcfg, 2, 24)
    tc = encdec.init_cache(tcfg, 2, 24, "cpu")
    want, jc = jencdec.decode(jcfg, jp, jnp.asarray(toks[:, :17]), jenc,
                              mode="prefill", cache=jc)
    with torch.inference_mode():
        got, tc = encdec.decode(tcfg, tp, torch.from_numpy(toks[:, :17]),
                                tenc, mode="prefill", cache=tc)
    _close(got, want)
    for pos in (17, 18, 19):
        want, jc = jencdec.decode(jcfg, jp, jnp.asarray(toks[:, pos:pos + 1]),
                                  jenc, mode="decode", cache=jc, pos=pos)
        with torch.inference_mode():
            got, tc = encdec.decode(tcfg, tp,
                                    torch.from_numpy(toks[:, pos:pos + 1]),
                                    tenc, mode="decode", cache=tc, pos=pos)
        _close(got, want)


def test_decode_step_reads_enc_and_never_writes_it(pair):
    _, _, tcfg, tp = pair
    model = api.build(tcfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    with torch.inference_mode():
        _, cache = model.prefill(tp, b, max_len=24)
        enc = cache["enc"].clone()
        k0 = cache["dec"][0]["k"]
        for pos in (17, 18):
            _, cache = model.decode_step(tp, cache, b["tokens"][:, :1], pos)
    assert torch.equal(cache["enc"], enc)
    assert cache["dec"][0]["k"] is k0                 # written in place
    assert bool(k0[:, 18].abs().sum() > 0)
    cache0 = model.init_cache(2, 24)
    assert tuple(cache0["enc"].shape) == (2, tcfg.encdec.encoder_len,
                                          tcfg.d_model)
    assert len(cache0["dec"]) == tcfg.n_layers


@pytest.mark.parametrize("step", [0, 5])
def test_lm_batch_frames_are_the_jax_packages(step):
    jcfg, tcfg = _configs()
    want = jsynthetic.lm_batch(jcfg, 3, step, 4, 16)
    got = synthetic.lm_batch(tcfg, 3, step, 4, 16)
    assert got.keys() == want.keys() == {"tokens", "frames"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    it = synthetic.iterator(tcfg, 4, 16, seed=3, start_step=step, prefetch=0,
                            device="cpu")
    b = next(it)
    it.close()
    np.testing.assert_array_equal(b["frames"].numpy(), want["frames"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_for_bit(dtype):
    jcfg, tcfg = _configs(dtype)
    jp = jax.tree.map(np.asarray, japi.build(jcfg).init(
        jax.random.PRNGKey(1)))
    back = convert.params_to_numpy(tcfg, convert.params_from_numpy(
        tcfg, jp, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_batch_spec_is_the_jax_packages():
    jcfg, tcfg = _configs("bfloat16")
    want = japi.build(jcfg).batch_spec(4, 32)
    got = api.build(tcfg, device="cpu").batch_spec(4, 32)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].device.type == "meta"
        assert str(got[k].dtype)[6:] == str(want[k].dtype)


def test_init_shapes_are_the_jax_packages():
    jcfg, tcfg = _configs("bfloat16")
    jp = japi.build(jcfg).init(jax.random.PRNGKey(0))
    tp = api.build(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = convert.params_to_numpy(tcfg, tp)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        assert a.shape == b.shape
