"""PyTorch port of the flash-attention kernel against the JAX package.

The same seeded numpy inputs go through the JAX package's Pallas kernel
(`flash_mha_pallas`, interpret mode) and through the port's plain versions
on the CPU: `ref.mha` (materialized softmax), which `ops.flash_mha` runs
on a CPU tensor; bf16 crosses as `uint16` bits. The
tolerances are the JAX kernel test's (`tests/test_kernels_flash.py`): fp32
2e-5, bf16 2e-2. Shapes the Pallas kernel refuses (T or S not a multiple
of the blocks) are held against the JAX package's `ref.mha`. The `cuda`
cases hold the CUDA kernel of each route (float32: fp32 cores; bfloat16:
tensor cores) against its plain version on the card, and a plain-PyTorch
model of the bf16 route's rounding records why its p·v splits p in two.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.flash_attention import flash_mha_pallas
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash, ops, ref
from repro_torch.weather import convert


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _inputs(b, t, s, h, kh, hd, dtype, seed=0):
    """q, k, v as jax arrays and as CPU tensors with the same bits."""
    rng = np.random.default_rng(seed)
    shapes = ((b, t, h, hd), (b, s, kh, hd), (b, s, kh, hd))
    js = [jnp.asarray(rng.normal(size=sh).astype(np.float32)).astype(dtype)
          for sh in shapes]
    return js, [convert.tensor_from_numpy(np.asarray(x), "cpu") for x in js]


def _np(t):
    return t.float().numpy()


def _run(b, t, s, h, kh, hd, dtype, causal, window, softcap, bq=64, bk=64):
    (jq, jk, jv), (q, k, v) = _inputs(b, t, s, h, kh, hd, dtype)
    want = np.asarray(flash_mha_pallas(jq, jk, jv, causal=causal,
                                       window=window, softcap=softcap,
                                       block_q=bq, block_k=bk,
                                       interpret=True), np.float32)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    got = ops.flash_mha(q, k, v, causal=causal, window=window,
                        softcap=softcap)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)
    plain = ref.mha(q, k, v, causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(_np(plain), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_basic_shapes(dtype, causal):
    _run(2, 128, 128, 4, 4, 32, dtype, causal, 0, 0.0)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [64, 256])
def test_gqa_groups_and_head_dims(g, hd):
    _run(1, 64, 64, 2 * g, 2, hd, "float32", True, 0, 0.0)


def test_mqa_bf16_at_recurrentgemma_head_dim():
    _run(1, 64, 64, 8, 1, 256, "bfloat16", True, 0, 0.0)


def test_sliding_window():
    _run(1, 256, 256, 2, 2, 32, "float32", True, 64, 0.0)


def test_softcap():
    _run(1, 128, 128, 2, 1, 32, "float32", True, 0, 30.0)


def test_cross_attention_rectangular():
    # prefill-style T != S, non-causal (whisper cross-attn shape)
    _run(2, 64, 192, 4, 2, 32, "float32", False, 0, 0.0)


@pytest.mark.parametrize("t,s,causal,window", [
    (77, 77, True, 0), (77, 77, True, 16), (50, 130, False, 0),
    (100, 40, True, 24), (1, 1, True, 0), (129, 65, False, 8)])
def test_ragged_lengths_match_the_jax_reference(t, s, causal, window):
    """T and S the blocks do not divide (the Pallas kernel refuses them);
    (100, 40) with a window leaves rows 63.. with no key at all, which the
    -1e30 sentinel turns into the mean of v, as in the reference."""
    (jq, jk, jv), (q, k, v) = _inputs(2, t, s, 4, 2, 16, "float32")
    want = np.asarray(jref.mha(jq, jk, jv, causal=causal, window=window))
    got = ops.flash_mha(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=2e-5)


def test_auto_blocks_fit_the_shared_memory():
    for hd in flash.HEAD_DIMS:
        bq, bk = ops.auto_blocks(hd)
        assert (bq, bk) == flash.BLOCKS[0]
        assert flash.smem_bytes(hd, bq, bk) <= ops.SMEM_BUDGET
    # hd 256 at (64, 64) needs 214,528 bytes: a smaller budget takes
    # (32, 32); none fits 64 KB
    assert flash.smem_bytes(256, 64, 64) == 214528
    assert ops.auto_blocks(256, budget=150_000) == (32, 32)
    with pytest.raises(ValueError, match="no block"):
        ops.auto_blocks(256, budget=65536)


def test_tc_blocks_fit_the_shared_memory():
    """The bf16 route's tiles: (128, 128) up to hd 128 and (128, 64) at hd
    256 (whose (128, 128) would need 328,704 bytes), each within the
    232,448 bytes a block may opt into; `Tiles` in flash_attn_tc.cu."""
    bf16 = torch.bfloat16
    for hd in flash.HEAD_DIMS:
        bq, bk = ops.auto_blocks(hd, dtype=bf16)
        assert (bq, bk) == ((128, 128) if hd <= 128 else (128, 64))
        assert flash.smem_bytes(hd, bq, bk, bf16) <= ops.SMEM_BUDGET
        assert (bq, bk) in flash.blocks(bf16) == flash.TC_BLOCKS
    assert flash.smem_bytes(256, 128, 64, bf16) == 197632
    assert flash.smem_bytes(256, 128, 128, bf16) == 328704
    assert flash.smem_bytes(128, 128, 128, bf16) == 164864
    with pytest.raises(ValueError, match="no block"):
        ops.auto_blocks(256, budget=150_000, dtype=bf16)
    # the fp32 route keeps its own tiles
    assert flash.blocks(torch.float32) == flash.BLOCKS


def _tc_model(q, k, v, *, causal, split_p):
    """A plain-PyTorch model of the bf16 route's rounding on bf16 q, k, v
    (B, T, H, hd), MHA: the products of bf16 values with fp32 sums, the
    scale on the fp32 scores, p = exp(s - max) in fp32 for the sum, and p·v
    with p as bf16(p) + bf16(p - bf16(p)) (`split_p`) or as one bf16;
    the output rounded to bf16 once."""
    hd = q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * hd ** -0.5
    if causal:
        t = q.shape[1]
        keep = torch.ones(t, t, dtype=torch.bool).tril()
        s = torch.where(keep, s, ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float() if split_p else torch.zeros_like(p)
    o = torch.einsum("bhts,bshd->bthd", hi, v.float()) + torch.einsum(
        "bhts,bshd->bthd", lo, v.float())
    return (o / p.sum(-1).transpose(1, 2)[..., None]).bfloat16()


@pytest.mark.parametrize("causal", [False, True])
def test_tc_rounding_model_needs_p_split_in_two(causal):
    """With p as hi + lo the route's rounding meets the bf16 gate
    (2e-5 + 2^-8|want|) against `ref.mha` in fp32 on the same bf16 inputs;
    with p as one bf16 it does not: 2^-9·|p_j v_j| a term exceeds the
    gate where the output is near 0."""
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(2, 256, 4, 64, generator=gen).bfloat16()
               for _ in range(3))
    want = ref.mha(q.float(), k.float(), v.float(), causal=causal)

    def excess(got):
        return float(((got.float() - want).abs()
                      - (2e-5 + 2.0 ** -8 * want.abs())).max())

    assert excess(_tc_model(q, k, v, causal=causal, split_p=True)) <= 0.0
    assert excess(_tc_model(q, k, v, causal=causal, split_p=False)) > 0.0


def test_attention_flops_count_the_kept_pairs():
    assert flash.attention_flops(1, 4, 4, 1, 8, causal=True) == 4 * 8 * 10
    assert flash.attention_flops(2, 3, 5, 2, 8, causal=False) == \
        4 * 8 * 2 * 2 * 15
    assert flash.attention_flops(1, 6, 6, 1, 1, causal=True, window=2) == \
        4 * 11


def test_both_versions_refuse_the_same_shapes():
    q = torch.zeros(1, 8, 3, 16)
    k = torch.zeros(1, 8, 2, 16)
    for fn in (ops.flash_mha, flash.flash_mha_cuda):
        with pytest.raises(ValueError, match="multiple"):
            fn(q, k, k)
        with pytest.raises(ValueError, match="window"):
            fn(q, q, q, window=-1)
        with pytest.raises(ValueError):
            fn(q, q.double(), q)


def test_cpu_call_launches_nothing():
    (_, _, _), (q, k, v) = _inputs(1, 64, 64, 2, 1, 16, "float32")
    before = dict(_build.LAUNCHES)
    ops.flash_mha(q, k, v)
    assert _build.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    (_, _, _), (q, k, v) = _inputs(1, 64, 64, 2, 1, 16, "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash.flash_mha_cuda(q, k, v)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CUDA_CASES = [
    # b, t, s, h, kh, hd, causal, window, softcap
    (2, 256, 256, 16, 1, 256, True, 0, 0.0),      # recurrentgemma MQA
    (2, 256, 256, 32, 4, 64, True, 0, 0.0),       # tinyllama GQA g = 8
    (2, 77, 77, 8, 1, 64, True, 0, 0.0),          # ragged T
    (1, 256, 256, 2, 2, 32, True, 64, 0.0),       # window
    (1, 128, 128, 2, 1, 32, True, 0, 30.0),       # softcap
    (2, 64, 192, 4, 2, 128, False, 0, 0.0),       # T != S non-causal
    (1, 300, 200, 8, 1, 16, True, 50, 0.0),       # rows with no key
]


def _cuda_inputs(case, dtype, dev, seed=0):
    b, t, s, h, kh, hd = case[:6]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, t, h, hd), (b, s, kh, hd), (b, s, kh, hd))]


def _within_gate(got, q, k, v, causal, window, softcap):
    """The kernel against its plain version in fp32 from the same inputs:
    |got - want| <= 2e-5 + rtol·|want| (fp32: the JAX kernel test's 2e-5;
    bf16: the output's one rounding, 2^-8)."""
    want = ref.mha(q.float(), k.float(), v.float(), causal=causal,
                   window=window, softcap=softcap)
    rtol = 2e-5 if q.dtype == torch.float32 else 2.0 ** -8
    return bool(((got.float() - want).abs()
                 <= 2e-5 + rtol * want.abs()).all())


# each route's tiles: float32 takes the fp32-core kernel, bfloat16 the
# tensor-core kernel
ROUTE_BLOCKS = ([(torch.float32, b) for b in flash.BLOCKS]
                + [(torch.bfloat16, b) for b in flash.TC_BLOCKS])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
@pytest.mark.parametrize("dtype,blocks", ROUTE_BLOCKS)
def test_cuda_kernel_matches_plain(case, dtype, blocks, cuda):
    b, t, s, h, kh, hd, causal, window, softcap = case
    q, k, v = _cuda_inputs(case, dtype, cuda)
    _build.reset_launches()
    if flash.smem_bytes(hd, *blocks, dtype) > ops.SMEM_BUDGET:
        # hd 256 at the bf16 route's (128, 128): refused before launch
        with pytest.raises(ValueError, match="shared memory"):
            flash.flash_mha_cuda(q, k, v, block_q=blocks[0],
                                 block_k=blocks[1])
        assert _build.LAUNCHES["flash_attn"] == 0
        return
    got = flash.flash_mha_cuda(q, k, v, causal=causal, window=window,
                               softcap=softcap, block_q=blocks[0],
                               block_k=blocks[1])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    assert _within_gate(got, q, k, v, causal, window, softcap)


TC_CASES = [
    # b, t, s, h, kh, hd, causal, window, softcap
    *[(2, 200, 200, 4, 2, hd, True, 0, 0.0) for hd in flash.HEAD_DIMS],
    *[(2, 256, 256, 8, 8 // g, 64, True, 0, 0.0) for g in (1, 2, 4, 8)],
    (1, 700, 700, 4, 1, 256, True, 128, 0.0),     # window, skipped blocks
    (1, 700, 700, 4, 2, 64, True, 200, 0.0),
    (2, 256, 256, 8, 1, 64, True, 0, 30.0),       # softcap
    (2, 333, 257, 8, 2, 128, True, 64, 0.0),      # ragged T and S
    (2, 100, 300, 4, 2, 32, False, 0, 0.0),       # T != S non-causal
    (1, 300, 200, 8, 1, 16, True, 50, 0.0),       # rows with no key
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES)
@pytest.mark.parametrize("blocks", flash.TC_BLOCKS)
def test_cuda_tc_route_matches_plain(case, blocks, cuda):
    """The bf16 tensor-core kernel over its own tiles: every head dim,
    GQA g 1-8, window with skipped kv blocks, softcap, ragged T and S,
    T != S non-causal, rows with no key, at the bf16 gate."""
    b, t, s, h, kh, hd, causal, window, softcap = case
    if flash.smem_bytes(hd, *blocks, torch.bfloat16) > ops.SMEM_BUDGET:
        blocks = ops.auto_blocks(hd, dtype=torch.bfloat16)
    q, k, v = _cuda_inputs(case, torch.bfloat16, cuda, seed=3)
    got = flash.flash_mha_cuda(q, k, v, causal=causal, window=window,
                               softcap=softcap, block_q=blocks[0],
                               block_k=blocks[1])
    torch.cuda.synchronize()
    assert _within_gate(got, q, k, v, causal, window, softcap)


@pytest.mark.cuda
def test_cuda_bf16_runs_the_tensor_core_kernel(cuda):
    """`ops.flash_mha` on bf16 CUDA tensors launches `flash_fwd_tc` once
    and no other kernel of the port; float32 launches `flash_fwd`."""
    from torch.profiler import ProfilerActivity, profile

    for dtype, want in ((torch.bfloat16, "flash_fwd_tc"),
                        (torch.float32, "flash_fwd")):
        q, k, v = _cuda_inputs((1, 128, 128, 4, 1, 64), dtype, cuda)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops.flash_mha(q, k, v)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        ours = [n for n in names if "flash_fwd" in n]
        assert len(ours) == 1 and f"{want}<" in ours[0], names


@pytest.mark.cuda
def test_cuda_kernel_reads_strided_operands(cuda):
    """q, k, v as views into fused projections (no copy)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 64, 8 + 2 + 2, 32, generator=gen, device=cuda)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = ops.flash_mha(q, k, v)
    want = ref.mha(q, k, v)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_tc_route_reads_strided_operands(offset, cuda):
    """bf16 views into a fused projection: rows 16-byte aligned (cp.async)
    and, one element further on, rows that are not (the scalar copy)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    flat = torch.randn(2 * 96 * 12 * 64 + offset, generator=gen,
                       device=cuda).bfloat16()
    qkv = flat[offset:].view(2, 96, 12, 64)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = ops.flash_mha(q, k, v, window=40)
    torch.cuda.synchronize()
    assert _within_gate(got, q, k, v, True, 40, 0.0)


@pytest.mark.cuda
def test_cuda_kernel_refuses_grad(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        flash.flash_mha_cuda(q, q.detach(), q.detach())


# ---------------------------------------------------------------------------
# the gradient: FlashFn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,h,kh,window,softcap", [
    (32, 4, 1, 0, 0.0), (40, 4, 2, 8, 0.0), (24, 2, 2, 0, 20.0)])
def test_flashfn_matches_jax_grad(t, h, kh, window, softcap):
    """`ops.flash_mha` through `FlashFn` (plain forward on the CPU; the
    backward recomputes `ref.mha`) against `jax.grad` of the JAX model's
    `attention.flash_attention`, which training differentiates, fp32."""
    import jax

    from repro.models import attention as jattn

    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((2, t, h, 16), (2, t, kh, 16), (2, t, kh, 16)))
    cot = rng.normal(size=(2, t, h, 16)).astype(np.float32)

    def jloss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=True, window=window,
                                    q_chunk=8, kv_chunk=8, softcap=softcap)
        return (out * cot).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.flash_mha(*xs, causal=True, window=window, softcap=softcap)
    assert out.grad_fn is not None and "FlashFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flashfn_gradients_match_the_cpu(dtype, cuda):
    gen = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(sh, generator=gen).to(dtype)
               for sh in ((2, 96, 8, 64), (2, 96, 2, 64), (2, 96, 2, 64)))
    cot = torch.randn(2, 96, 8, 64, generator=gen)
    out = []
    for dev in ("cpu", cuda):
        xs = [x.to(dev).requires_grad_() for x in (q, k, v)]
        _build.reset_launches()
        o = ops.flash_mha(*xs, window=32)
        grads = torch.autograd.grad((o.float() * cot.to(dev)).sum(), xs)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert _build.LAUNCHES["flash_attn"] == 1
        out.append([o.detach().float().cpu()] + [g.float().cpu()
                                                  for g in grads])
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for c, g in zip(*out):
        assert float((c - g).abs().max()) <= tol * max(1.0,
                                                       float(c.abs().max()))
