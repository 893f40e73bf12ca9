"""PyTorch port of the LMs against the JAX package.

The JAX package's parameters (`model.init(PRNGKey(0))`) cross into the
port through `models.convert.params_from_numpy`; the same seeded tokens go
through both packages' `prefill` and `decode_step`. Reduced configs of
tinyllama (dense GQA), recurrentgemma (RG-LRU + MQA), gemma3 (local/global
attention, qk-norm, sandwich norms, a ring-aligned local cache) and olmo
(non-parametric LayerNorm, tied head). In fp32 the logits agree within the
JAX package's own prefill/decode equivalence tolerance, 3e-4
(`tests/test_models_equivalence.py`). In bf16 the two frameworks round at
other places (the JAX CPU backend keeps some fused chains in fp32), so the
bound is 0.05: about 13 bf16 ulps at the logits' scale of ~0.65.

The other five configurations (`FAMILIES`: granite and moonshot (MoE),
mamba2 (SSD), whisper (encoder-decoder, with its frames) and qwen2-vl
(M-RoPE)) are held in fp32 within 1e-5 of the logits' largest magnitude.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import rglru as jrglru
from repro_torch.configs import registry as treg
from repro_torch.data import synthetic
from repro_torch.kernels import _build
from repro_torch.models import (api, attention, blocks, common, convert,
                                encdec, lm, mlp, rglru)

ARCHS = ["tinyllama-1.1b", "recurrentgemma-9b", "gemma3-27b", "olmo-1b"]
FAMILIES = ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "mamba2-1.3b",
            "whisper-medium", "qwen2-vl-72b"]
T = 24
FP32_TOL = 3e-4
BF16_TOL = 0.05
FAMILY_TOL = 1e-5                 # of the logits' largest magnitude


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _configs(arch, dtype="float32", **kw):
    """The reduced config in both packages, in `dtype`."""
    out = []
    for reg in (jreg, treg):
        cfg = reg.reduced_config(reg.get_config(arch))
        out.append(dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype,
                                       **kw))
    return out


def _pair(arch, dtype="float32", **kw):
    """(jax model, jax params, port model, port params) on the CPU."""
    jcfg, tcfg = _configs(arch, dtype, **kw)
    jm = japi.build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = api.build(tcfg, device="cpu")
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(2, T + 1)).astype(np.int32)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _frames(cfg, seed=2):
    """An encoder-decoder's seeded frames, else None."""
    if not cfg.encdec:
        return None
    return np.random.default_rng(seed).normal(
        size=(2, cfg.encdec.encoder_len, cfg.d_model)).astype(np.float32)


def _jax_logits(jm, jp, toks, frames=None):
    batch = {"tokens": jnp.asarray(toks[:, :T])}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    lp, cache = jm.prefill(jp, batch, max_len=T + 8)
    ld, _ = jm.decode_step(jp, cache, jnp.asarray(toks[:, T:]), T)
    return _f32(lp), _f32(ld)


def _port_logits(tm, tp, toks, device="cpu", frames=None):
    batch = {"tokens": torch.from_numpy(toks[:, :T]).to(device)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames).to(device)
    with torch.inference_mode():
        lp, cache = tm.prefill(tp, batch, max_len=T + 8)
        ld, _ = tm.decode_step(tp, cache, torch.from_numpy(
            toks[:, T:]).to(device), T)
    return _f32(lp.cpu()), _f32(ld.cpu())


def _close(got, want, tol=FAMILY_TOL):
    """|got − want| within `tol` of want's largest magnitude."""
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_prefill_and_decode_match_jax(arch, dtype, tol):
    jm, jp, tm, tp = _pair(arch, dtype)
    toks = _tokens(tm.cfg.vocab_size)
    want_p, want_d = _jax_logits(jm, jp, toks)
    got_p, got_d = _port_logits(tm, tp, toks)
    assert got_p.shape == want_p.shape and got_d.shape == want_d.shape
    np.testing.assert_allclose(got_p, want_p, atol=tol, rtol=tol)
    np.testing.assert_allclose(got_d, want_d, atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """The port against itself, as `test_models_equivalence.py:118` holds
    the JAX package: prefill's last logits and one decode step equal the
    full forward pass over T + 1 tokens."""
    tcfg = _configs(arch)[1]
    tm = api.build(tcfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    toks = _tokens(tcfg.vocab_size)
    with torch.inference_mode():
        full, _, _ = lm.apply(tcfg, tp, torch.from_numpy(toks),
                              mode="train")
    got_p, got_d = _port_logits(tm, tp, toks)
    np.testing.assert_allclose(got_p[:, -1], _f32(full)[:, T - 1],
                               atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(got_d[:, 0], _f32(full)[:, T],
                               atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-27b"])
def test_int8_kv_cache_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch, kv_dtype="int8")
    toks = _tokens(tm.cfg.vocab_size, seed=3)
    want_p, want_d = _jax_logits(jm, jp, toks)
    got_p, got_d = _port_logits(tm, tp, toks)
    np.testing.assert_allclose(got_p, want_p, atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(got_d, want_d, atol=FP32_TOL, rtol=FP32_TOL)


def test_int8_cache_contents_match_jax(rng):
    x = rng.normal(size=(2, 5, 2, 16)).astype(np.float32)
    jq, js = jblocks._kv_quant(jnp.asarray(x))
    tq, ts = blocks._kv_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(
        blocks._kv_dequant(tq, ts, torch.float32).numpy(),
        np.asarray(jblocks._kv_dequant(jq, js, jnp.float32)), rtol=1e-7)


def test_params_carry_across_unchanged():
    """Every leaf keeps its JAX layout, dtype and bits; superblocks unstack
    into layers in the forward order."""
    jcfg, tcfg = _configs("recurrentgemma-9b", "bfloat16")
    jp = japi.build(jcfg).init(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    assert [b.kind for b in tp.blocks] == lm.layer_kinds(tcfg) == \
        ["rec", "rec", "attn", "rec", "rec"]
    sb = jp["superblocks"]["b1"]["rec"]["w_in_gate"]
    got = tp.blocks[1].params["rec"]["w_in_gate"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == sb.shape[1:]
    assert np.array_equal(got.view(torch.uint16).numpy(),
                          np.asarray(sb[0]).view(np.uint16))
    assert tp.blocks[4].params["rec"]["lam"].dtype == torch.float32
    assert tp.blocks[2].params["norm1"]["scale"].dtype == torch.float32
    rem = jp["rem1"]["ffn"]["wo"]
    assert np.array_equal(
        tp.blocks[4].params["ffn"]["wo"].view(torch.uint16).numpy(),
        np.asarray(rem).view(np.uint16))
    n_port = sum(p.numel() for p in tp.parameters())
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert n_port == n_jax
    assert not any(p.requires_grad for p in tp.parameters())


def test_untied_head_and_init_shapes():
    """A random init of the port has the JAX package's tree shapes."""
    jcfg, tcfg = _configs("tinyllama-1.1b")
    jp = japi.build(jcfg).init(jax.random.PRNGKey(0))
    tp = api.build(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert tuple(tp.head.shape) == jp["head"].shape
    assert tuple(tp.embed.shape) == jp["embed"].shape
    jshapes = [x.shape[1:] for x in
               jax.tree.leaves(jp["superblocks"])]
    tshapes = [tuple(p.shape) for p in tp.blocks[0].parameters()]
    assert sorted(jshapes) == sorted(tshapes)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_and_decode_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(tm.cfg.vocab_size)
    frames = _frames(tm.cfg)
    want_p, want_d = _jax_logits(jm, jp, toks, frames)
    got_p, got_d = _port_logits(tm, tp, toks, frames=frames)
    _close(got_p, want_p)
    _close(got_d, want_d)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_decode_matches_full_forward(arch):
    """The port against itself, as `test_models_equivalence.py:118` holds
    the JAX package (MoE with a capacity no token overflows, so that the
    routing is the same in every path)."""
    kw = {}
    moe = treg.reduced_config(treg.get_config(arch)).moe
    if moe:
        kw["moe"] = dataclasses.replace(moe, capacity_factor=4.0)
    tcfg = _configs(arch, **kw)[1]
    tm = api.build(tcfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    toks = _tokens(tcfg.vocab_size)
    frames = _frames(tcfg)
    with torch.inference_mode():
        if tcfg.encdec:
            enc = encdec.encode(tcfg, tp, torch.from_numpy(frames))
            full, _ = encdec.decode(tcfg, tp, torch.from_numpy(toks), enc)
        else:
            full, _, _ = lm.apply(tcfg, tp, torch.from_numpy(toks),
                                  mode="train")
    got_p, got_d = _port_logits(tm, tp, toks, frames=frames)
    np.testing.assert_allclose(got_p[:, -1], _f32(full)[:, T - 1],
                               atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(got_d[:, 0], _f32(full)[:, T],
                               atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_every_config_builds_and_its_loss_runs(arch):
    """Every one of the ten reduced configurations builds on the CPU, and
    its loss is finite and near log(vocab) at a random init."""
    cfg = treg.reduced_config(treg.get_config(arch))
    model = api.build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic.lm_batch(cfg, 0, 0, 2, 9).items()}
    assert ("frames" in batch) == (model.family == "encdec")
    loss = float(model.loss(params, batch))
    assert abs(loss - np.log(cfg.vocab_size)) < 1.0, loss


def test_remat_dots_still_raises():
    """Named for the refusal it held: `remat="dots"` is ported, and on a MoE
    config (its router and dispatch products among the saved 2-D dots) the
    loss and gradients equal `"none"`'s."""
    cfg = treg.reduced_config(treg.get_config("granite-moe-3b-a800m"))
    model = api.build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    params.requires_grad_(True)
    batch = {"tokens": torch.arange(8, dtype=torch.long).reshape(2, 4)}
    out = []
    for remat in ("none", "dots"):
        loss = model.loss(params, batch, remat=remat)
        out.append([loss] + list(torch.autograd.grad(
            loss, list(params.parameters()))))
    for a, b in zip(*out):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


def test_build_defaults_to_the_card():
    cfg = treg.reduced_config(treg.get_config("tinyllama-1.1b"))
    if torch.cuda.is_available():
        assert api.build(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            api.build(cfg)
    model = api.build(cfg, device="cpu")
    assert model.device == torch.device("cpu")


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_are_the_jax_packages(arch):
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    for fn in (lambda r: r.get_config(arch),
               lambda r: r.reduced_config(r.get_config(arch))):
        j, t = fn(jreg), fn(treg)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.hd, j.padded_vocab, j.n_repeats, j.n_remainder,
                j.param_count()) == (t.hd, t.padded_vocab, t.n_repeats,
                                     t.n_remainder, t.param_count())


# ---------------------------------------------------------------------------
# modules one by one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rms", "ln", "ln_nonparam"])
def test_norms_match_jax(norm, rng):
    jcfg, tcfg = _configs("olmo-1b", norm=norm)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = np.asarray(jcommon.norm_apply(jcfg, jp, jnp.asarray(x)))
    got = common.norm_apply(tcfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        common.qk_norm_apply(torch.from_numpy(q), tp["scale"][:16]).numpy(),
        np.asarray(jcommon.qk_norm_apply(jnp.asarray(q), jp["scale"][:16])),
        atol=1e-5, rtol=1e-5)


def test_mrope_matches_jax(rng):
    """M-RoPE with three position components that differ (an image
    token's time, height and width), and with text positions, where the
    three coincide and M-RoPE is the standard rotation."""
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos3 = rng.integers(0, 500, size=(2, 9, 3))
    sections = (2, 3, 3)
    want = np.asarray(jcommon.rope_apply(jnp.asarray(x), jnp.asarray(pos3),
                                         1e6, sections))
    got = common.rope_apply(torch.from_numpy(x), torch.from_numpy(pos3),
                            1e6, sections).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    text = np.broadcast_to(np.arange(9), (2, 9))
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(
        common.rope_apply(tx, torch.from_numpy(
            np.repeat(text[..., None], 3, axis=-1)), 1e6, sections).numpy(),
        common.rope_apply(tx, torch.from_numpy(text.copy()), 1e6).numpy(),
        atol=1e-6, rtol=1e-6)
    tcfg = _configs("qwen2-vl-72b")[1]
    assert tuple(lm._positions(tcfg, 2, 5, 7, "cpu").shape) == (2, 5, 3)


def test_embeddings_input_matches_jax(rng):
    """`lm.apply(embeddings=...)`, the modality stubs' input, with M-RoPE:
    the hidden states and the aux term against the JAX package's."""
    jm, jp, tm, tp = _pair("qwen2-vl-72b")
    emb = rng.normal(size=(2, 11, tm.cfg.d_model)).astype(np.float32)
    want, _, want_aux = jlm.apply(jm.cfg, jp, embeddings=jnp.asarray(emb),
                                  return_hidden=True)
    with torch.inference_mode():
        got, _, aux = lm.apply(tm.cfg, tp, embeddings=torch.from_numpy(emb),
                               return_hidden=True)
    _close(_f32(got), _f32(want))
    assert float(aux) == float(want_aux) == 0.0


def test_rope_matches_jax(rng):
    x = rng.normal(size=(2, 9, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + 100, (2, 9))
    for theta in (1e4, 1e6):
        want = np.asarray(jcommon.rope_apply(jnp.asarray(x),
                                             jnp.asarray(pos), theta))
        got = common.rope_apply(torch.from_numpy(x),
                                torch.from_numpy(pos.copy()), theta).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False), ("relu", False)])
def test_mlp_matches_jax(act, gated, rng):
    jcfg, tcfg = _configs("tinyllama-1.1b", act=act, gated_mlp=gated)
    p = {k: rng.normal(size=s).astype(np.float32) / 8 for k, s in
         (("wi", (64, 128)), ("wo", (128, 64)), ("wg", (64, 128)))}
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    want = np.asarray(jmlp.mlp_apply(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = mlp.mlp_apply(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_softplus_and_gelu_are_jaxs():
    x = np.linspace(-40, 40, 801).astype(np.float32)
    np.testing.assert_allclose(rglru.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(mlp.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("decode", [False, True])
def test_rglru_block_matches_jax(decode, rng):
    jcfg, tcfg = _configs("recurrentgemma-9b")
    jp = jrglru.rglru_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    t = 1 if decode else 7
    x = rng.normal(size=(2, t, 64)).astype(np.float32)
    jstate = tstate = None
    if decode:
        h = rng.normal(size=(2, 64)).astype(np.float32)
        conv = rng.normal(size=(2, 3, 64)).astype(np.float32)
        jstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        tstate = {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)}
    want, wst = jrglru.rglru_block_apply(jcfg, jp, jnp.asarray(x), jstate)
    got, gst = rglru.rglru_block_apply(tcfg, tp, torch.from_numpy(x), tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t,kv,window,softcap", [
    (32, 4, 0, 0.0), (64, 2, 16, 0.0), (32, 1, 0, 20.0), (48, 2, 0, 0.0)])
def test_model_flash_attention_matches_jax(t, kv, window, softcap, rng):
    b, h, hd = 2, 4, 16
    q = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    want = np.asarray(jattn.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, window=window,
        q_chunk=16, kv_chunk=16, softcap=softcap))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attention._flash_attention(tq, tk, tv, causal=True, window=window,
                                     q_chunk=16, kv_chunk=16,
                                     softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    # the public entry point: on a CPU tensor, the body at its default chunks
    want = np.asarray(jattn.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, window=window,
        softcap=softcap))
    got = attention.flash_attention(tq, tk, tv, causal=True, window=window,
                                    softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("pos,window", [(10, 0), (23, 0), (5, 8), (30, 8)])
def test_decode_attention_matches_jax(pos, window, rng):
    s = window or 24
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    want = np.asarray(jattn.decode_attention(*map(jnp.asarray, (q, k, v)),
                                             pos, window=window))
    got = attention.decode_attention(*map(torch.from_numpy, (q, k, v)), pos,
                                     window=window).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_cpu_models_launch_nothing():
    _, tcfg = _configs("recurrentgemma-9b")
    tm = api.build(tcfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    _build.reset_launches()
    _port_logits(tm, tp, _tokens(tcfg.vocab_size))
    assert all(n == 0 for n in _build.LAUNCHES.values())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_model_matches_cpu_model(arch, cuda):
    """The same reduced fp32 model on the card (flash and LRU kernels)
    and on the CPU (plain versions), within the fp32 parity tolerance."""
    _, tcfg = _configs(arch)
    tp = api.build(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = _tokens(tcfg.vocab_size)
    want_p, want_d = _port_logits(api.build(tcfg, device="cpu"), tp, toks)
    tp_gpu = tp.to(cuda)
    _build.reset_launches()
    got_p, got_d = _port_logits(api.build(tcfg, device=cuda), tp_gpu, toks,
                                device=cuda)
    kinds = lm.layer_kinds(tcfg)
    n_attn = sum(k != "rec" for k in kinds)
    n_rec = len(kinds) - n_attn
    assert _build.LAUNCHES["flash_attn"] == n_attn
    assert _build.LAUNCHES["lru_scan"] == 2 * n_rec
    np.testing.assert_allclose(got_p, want_p, atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(got_d, want_d, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_family_matches_cpu_model(arch, cuda):
    """The same reduced fp32 model on the card (the flash kernel in every
    attention prefill, the encoder's non-causal) and on the CPU."""
    _, tcfg = _configs(arch)
    tp = api.build(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = _tokens(tcfg.vocab_size)
    frames = _frames(tcfg)
    want_p, want_d = _port_logits(api.build(tcfg, device="cpu"), tp, toks,
                                  frames=frames)
    _build.reset_launches()
    got_p, got_d = _port_logits(api.build(tcfg, device=cuda), tp.to(cuda),
                                toks, device=cuda, frames=frames)
    n_attn = 0 if tcfg.is_attention_free else tcfg.n_layers + (
        tcfg.encdec.encoder_layers if tcfg.encdec else 0)
    assert _build.LAUNCHES["flash_attn"] == n_attn
    np.testing.assert_allclose(got_p, want_p, atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(got_d, want_d, atol=FP32_TOL, rtol=FP32_TOL)
