"""PyTorch port of the LM serving engine: the JAX engine's own cases, run
on the port, and the port's greedy tokens against the JAX engine's.

The JAX package's `tests/test_serve_engine.py` cases (continuous batching,
greedy equal to a hand-rolled prefill + decode loop, per-request latency,
sampled tokens inside the logical vocab) run on the port's `ServeEngine` on
the CPU. Then both engines serve the same requests with the same converted
fp32 parameters (reduced tinyllama and recurrentgemma): the tokens must be
equal wherever the choice is clear, that is up to a request's first step
whose top-2 logit gap in the JAX model is at most 10× the fp32 logit
tolerance (3e-4), so a near-tie, which the two packages may break
differently, does not decide the test. The same holds for the five other
families (MoE, SSD, the encoder-decoder with its zero frames, M-RoPE).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import registry
from repro_torch.kernels import _build
from repro_torch.models import api, convert
from repro_torch.serve.engine import Request, ServeEngine

GAP = 10 * 3e-4
FAMILIES = ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "mamba2-1.3b",
            "whisper-medium", "qwen2-vl-72b"]


@pytest.fixture(scope="module")
def served():
    cfg = registry.reduced_config(registry.get_config("tinyllama-1.1b"),
                                  layers=2)
    model = api.build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _engine(model, params, **kw):
    return ServeEngine(model, params, device=model.device, **kw)


def test_continuous_batching_processes_all(served):
    cfg, model, params = served
    eng = _engine(model, params, batch=2, max_len=64)
    reqs = [Request(rid=i, prompt=np.arange(1, 5 + i, dtype=np.int32) % 250,
                    max_new_tokens=4) for i in range(5)]
    out = eng.run(reqs)
    assert sorted(out) == [0, 1, 2, 3, 4]
    assert all(len(v) == 4 for v in out.values())
    assert all(0 <= t < cfg.padded_vocab for v in out.values() for t in v)
    assert len(eng.stats["prefill_s"]) == 3          # waves of 2, 2, 1
    assert len(eng.stats["decode_s"]) == 3 * 3


def test_greedy_matches_stepwise_reference(served):
    """Engine greedy decode == hand-rolled prefill + decode_step loop."""
    cfg, model, params = served
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    eng = _engine(model, params, batch=1, max_len=32)
    got = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=5)])[0]

    with torch.inference_mode():
        batch = {"tokens": torch.from_numpy(prompt[None, :])}
        logits, cache = model.prefill(params, batch, max_len=32)
        want = []
        tok = int(torch.argmax(logits[0, -1]))
        want.append(tok)
        pos = len(prompt)
        for _ in range(4):
            lg, cache = model.decode_step(params, cache,
                                          torch.tensor([[tok]]), pos)
            tok = int(torch.argmax(lg[0, -1]))
            want.append(tok)
            pos += 1
    assert got == want


def test_latency_is_per_request_not_per_wave(served):
    """A request's latency clock stops at ITS last token, not the wave's."""
    cfg, model, params = served
    eng = _engine(model, params, batch=2, max_len=64)
    short = Request(rid=0, prompt=np.asarray([1, 2, 3], np.int32),
                    max_new_tokens=1)
    long_ = Request(rid=1, prompt=np.asarray([4, 5, 6], np.int32),
                    max_new_tokens=12)
    out = eng.run([short, long_])
    assert len(out[0]) == 1 and len(out[1]) == 12
    assert 0.0 < short.latency_s < long_.latency_s


def test_sampled_tokens_stay_in_logical_vocab(served):
    """Temperature sampling must never emit a padded-vocab token."""
    cfg, model, params = served
    cfg = dataclasses.replace(cfg, vocab_size=200)   # 56 padded columns
    model = api.build(cfg, device="cpu")
    eng = _engine(model, params, batch=2, max_len=32, temperature=1.0,
                  seed=7)
    reqs = [Request(rid=i, prompt=np.asarray([1, 2, 3], np.int32),
                    max_new_tokens=8) for i in range(2)]
    out = eng.run(reqs)
    for toks in out.values():
        assert all(t < cfg.vocab_size for t in toks), toks
    again = _engine(model, params, batch=2, max_len=32, temperature=1.0,
                    seed=7).run(reqs)
    assert again == out                  # the seed fixes the stream


def test_engine_runs_on_the_card_unless_asked(served):
    cfg, model, params = served
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            ServeEngine(model, params, batch=1, max_len=8)
    else:
        with pytest.raises(ValueError, match="runs on"):
            ServeEngine(model, params, batch=1, max_len=8)


def _jax_waves(model, params, reqs, batch, max_len):
    """The JAX engine's waves run stepwise: each request's greedy tokens and
    the top-2 logit gap behind each of them."""
    plen = max(len(r.prompt) for r in reqs)
    toks_out, gaps = {}, {}
    for w in range(0, len(reqs), batch):
        active = reqs[w:w + batch]
        toks = np.zeros((batch, plen), np.int32)
        for i, r in enumerate(active):
            toks[i, plen - len(r.prompt):] = r.prompt
            toks_out[r.rid], gaps[r.rid] = [], []
        inputs = {"tokens": jnp.asarray(toks)}
        if model.cfg.encdec:      # the JAX engine's zero frames
            inputs["frames"] = jnp.zeros(
                (batch, model.cfg.encdec.encoder_len, model.cfg.d_model),
                jnp.float32)
        logits, cache = model.prefill(params, inputs, max_len=max_len)
        steps = max(r.max_new_tokens for r in active)
        for step in range(steps):
            last = np.asarray(logits[:, -1], np.float32)
            top2 = np.sort(last, axis=-1)[:, -2:]
            nxt = last.argmax(axis=-1)
            for i, r in enumerate(active):
                if len(toks_out[r.rid]) < r.max_new_tokens:
                    toks_out[r.rid].append(int(nxt[i]))
                    gaps[r.rid].append(float(top2[i, 1] - top2[i, 0]))
            if step < steps - 1:
                logits, cache = model.decode_step(
                    params, cache, jnp.asarray(nxt[:, None].astype(np.int32)),
                    plen + step)
    return toks_out, gaps


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b"]
                         + FAMILIES)
def test_greedy_tokens_equal_the_jax_engine(arch):
    jcfg = dataclasses.replace(jreg.reduced_config(jreg.get_config(arch)),
                               dtype="float32", param_dtype="float32")
    tcfg = dataclasses.replace(
        registry.reduced_config(registry.get_config(arch)), dtype="float32",
        param_dtype="float32")
    jm = japi.build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = api.build(tcfg, device="cpu")
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    mk = lambda cls: [cls(rid=i, prompt=p, max_new_tokens=6)
                      for i, p in enumerate(prompts)]

    want = JServeEngine(jm, jp, batch=2, max_len=32).run(mk(JRequest))
    stepwise, gaps = _jax_waves(jm, jp, mk(JRequest), 2, 32)
    assert want == stepwise
    got = _engine(tm, tp, batch=2, max_len=32).run(mk(Request))
    compared = 0
    for rid, toks in want.items():
        clear = next((i for i, g in enumerate(gaps[rid]) if g <= GAP),
                     len(toks))
        assert got[rid][:clear] == toks[:clear], (rid, got[rid], toks)
        compared += clear
    assert compared >= 15, compared         # of the 30 tokens served


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b"]
                         + FAMILIES)
def test_cuda_engine_matches_its_stepwise_loop(arch, cuda):
    cfg = registry.reduced_config(registry.get_config(arch))
    model = api.build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    _build.reset_launches()
    got = ServeEngine(model, params, batch=1, max_len=32).run(
        [Request(rid=0, prompt=prompt, max_new_tokens=5)])[0]
    kinds = cfg.pattern * cfg.n_repeats + cfg.pattern[:cfg.n_remainder]
    n_attn = sum(k not in ("rec", "ssd") for k in kinds) + (
        cfg.encdec.encoder_layers if cfg.encdec else 0)
    assert _build.LAUNCHES["flash_attn"] == n_attn
    batch = {"tokens": torch.from_numpy(prompt[None]).to(cuda)}
    if cfg.encdec:
        batch["frames"] = torch.zeros((1, cfg.encdec.encoder_len,
                                       cfg.d_model), device=cuda,
                                      dtype=torch.bfloat16)
    with torch.inference_mode():
        logits, cache = model.prefill(params, batch, max_len=32)
        want = [int(torch.argmax(logits[0, -1]))]
        for i in range(4):
            lg, cache = model.decode_step(
                params, cache, torch.tensor([[want[-1]]], device=cuda),
                len(prompt) + i)
            want.append(int(torch.argmax(lg[0, -1])))
    assert got == want
