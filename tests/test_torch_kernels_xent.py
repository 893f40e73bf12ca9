"""PyTorch port of the fused cross-entropy kernel against the JAX package.

The same seeded numpy inputs go through the JAX package's oracle
(`ref.xent`), its Pallas kernel (`xent_pallas`, interpret mode) and its
`fused_xent_mean` where their tiles divide the shapes, and through the
port's plain version (`ref.xent_rows`, which `ops.xent_rows` runs on a CPU
tensor) and `ops.fused_xent_mean`, at the JAX kernel test's tolerances
(`tests/test_kernels_xent.py`): 1e-4 in fp32 and 2e-2 in bf16, bf16
crossing as `uint16` bits. `XentFn`'s backward is held against `jax.grad`
of the JAX model's `lm.chunked_xent` within 1e-5 of max |grad| in fp32, for
a head contiguous along V (untied) and one that is `embed.T` (tied). The
`cuda` cases hold the CUDA kernel of each route (float32: fp32 cores;
bfloat16: tensor cores) against its plain version on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.kernels.xent import ref as jref
from repro.kernels.xent import xent_pallas
from repro.kernels.xent.ops import fused_xent_mean as jfused_xent_mean
from repro.models import lm as jlm
from repro_torch.kernels import _build
from repro_torch.kernels.xent import ops, ref, xent
from repro_torch.weather import convert


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _inputs(n, d, vp, vocab, dtype="float32", seed=0, valid_frac=None):
    """hidden, head, targets (and valid) as jax arrays and CPU tensors
    with the same bits."""
    rng = np.random.default_rng(seed)
    h = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32)).astype(dtype)
    w = (jnp.asarray(rng.normal(size=(d, vp)).astype(np.float32)) * 0.1
         ).astype(dtype)
    tg = rng.integers(0, vocab, size=n).astype(np.int32)
    valid = (None if valid_frac is None else
             (rng.random(n) < valid_frac).astype(np.float32))
    th, tw = (convert.tensor_from_numpy(np.asarray(x), "cpu") for x in (h, w))
    return ((h, w, jnp.asarray(tg), None if valid is None
             else jnp.asarray(valid)),
            (th, tw, torch.from_numpy(tg), None if valid is None
             else torch.from_numpy(valid)))


CASES = [
    # n, d, vp, vocab, dtype, softcap, valid_frac
    (128, 64, 512, 512, "float32", 0.0, None),
    (128, 64, 512, 512, "bfloat16", 0.0, None),
    (64, 32, 384, 300, "float32", 0.0, None),        # padded vocab
    (64, 32, 256, 256, "float32", 20.0, None),       # softcap
    (64, 32, 256, 250, "float32", 30.0, 0.5),        # all three
    (64, 32, 384, 300, "bfloat16", 30.0, 0.5),
]


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_the_jax_oracle_and_kernel(case):
    n, d, vp, vocab, dtype, softcap, valid_frac = case
    (jh, jw, jt, jv), (h, w, t, v) = _inputs(n, d, vp, vocab, dtype,
                                             valid_frac=valid_frac)
    want = float(jref.xent(jh, jw, jt, jv, vocab=vocab, softcap=softcap))
    kern = np.asarray(xent_pallas(jh, jw, jt, jv, vocab=vocab,
                                  softcap=softcap, block_n=64, block_v=128,
                                  interpret=True))
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    nll, lse = ops.xent_rows(h, w, t, v, vocab=vocab, softcap=softcap)
    assert nll.dtype == lse.dtype == torch.float32
    assert nll.shape == lse.shape == (n,)
    np.testing.assert_allclose(float(nll.sum()), want, rtol=tol)
    np.testing.assert_allclose(nll.numpy(), kern, rtol=tol, atol=tol)
    np.testing.assert_allclose(float(ref.xent(h, w, t, v, vocab, softcap)),
                               want, rtol=tol)
    if v is not None:
        assert float(nll[v == 0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vp,vocab,softcap", [(256, 250, 0.0),
                                              (512, 512, 30.0)])
def test_fused_mean_matches_the_jax_wrapper(dtype, vp, vocab, softcap):
    rng = np.random.default_rng(3)
    h = jnp.asarray(rng.normal(size=(2, 32, 16)).astype(np.float32)
                    ).astype(dtype)
    w = (jnp.asarray(rng.normal(size=(16, vp)).astype(np.float32)) * 0.1
         ).astype(dtype)
    tg = rng.integers(0, vocab, size=(2, 32)).astype(np.int32)
    want = float(jfused_xent_mean(h, w, jnp.asarray(tg), vocab=vocab,
                                  softcap=softcap, interpret=True))
    got = ops.fused_xent_mean(
        convert.tensor_from_numpy(np.asarray(h), "cpu"),
        convert.tensor_from_numpy(np.asarray(w), "cpu"),
        torch.from_numpy(tg), vocab=vocab, softcap=softcap)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want,
                               rtol=2e-2 if dtype == "bfloat16" else 1e-4)


def test_valid_mask_zeroes_rows():
    """The JAX test's all-ones case: masked rows are exactly 0."""
    hidden = torch.ones(64, 32)
    head = torch.ones(32, 128)
    targets = torch.zeros(64, dtype=torch.int32)
    valid = torch.zeros(64)
    valid[:10] = 1.0
    nll, _ = ops.xent_rows(hidden, head, targets, valid)
    assert float(nll[10:].abs().max()) == 0.0
    assert float(nll[:10].abs().min()) > 0.0


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("vp,vocab,softcap", [(384, 300, 0.0),
                                              (256, 256, 20.0)])
def test_xentfn_backward_matches_jax_grad_of_chunked_xent(tied, vp, vocab,
                                                         softcap):
    """The gradient the model's loss takes on the card (`XentFn`,
    recomputing 512 rows at a time) against XLA's gradient of the JAX
    model's `chunked_xent` (chunk 8, so several windows), fp32. Tied: the
    head is `embed.T`, a view contiguous along D."""
    rng = np.random.default_rng(5)
    b, t, d = 3, 200, 16       # N = 600 rows: two backward chunks
    h = rng.normal(size=(b, t, d)).astype(np.float32)
    w = (rng.normal(size=(d, vp)) * 0.3).astype(np.float32)
    tg = rng.integers(0, vocab, size=(b, t)).astype(np.int32)

    def jloss(h, w):
        return jlm.chunked_xent(h, w, jnp.asarray(tg), chunk=8,
                                softcap=softcap, vocab=vocab)

    want, (gh, gw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    leaf = torch.from_numpy(w.T.copy() if tied else w).requires_grad_()
    head = leaf.T if tied else leaf
    if tied:
        assert head.stride() == (1, d)
    loss = ops.fused_xent_mean(th, head, torch.from_numpy(tg), vocab=vocab,
                               softcap=softcap)
    dh, dleaf = torch.autograd.grad(loss, (th, leaf))
    dw = dleaf.T if tied else dleaf
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for got, exp in ((dh, gh), (dw, gw)):
        exp = np.asarray(exp)
        scale = float(np.abs(exp).max())
        assert float(np.abs(got.numpy() - exp).max()) <= 1e-5 * scale
    if vocab < vp:
        assert float(dw[:, vocab:].abs().max()) == 0.0


def _bf16_grads_vs_fp32(dev, tied, softcap):
    """XentFn's gradients on bf16 inputs and autograd of the plain version
    in fp32 on the same (bf16-valued) inputs; logits of order 10, where a
    bf16 product would leave p = exp(logit - lse) off by |logit|·2^-9."""
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(700, 64, generator=gen).bfloat16()
    leaf = torch.randn(1000, 64, generator=gen).bfloat16()
    t = torch.randint(0, 990, (700,), generator=gen)
    if not tied:
        leaf = leaf.T.contiguous()
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        hh = h.to(dev, dtype).requires_grad_()
        ll = leaf.to(dev, dtype).requires_grad_()
        head = ll.T if tied else ll
        nll = (ops.xent(hh, head, t.to(dev), vocab=990, softcap=softcap)
               if dtype == torch.bfloat16 else
               ref.xent_rows(hh, head, t.to(dev), None, 990, softcap)[0])
        out.append(torch.autograd.grad(nll.sum(), (hh, ll)))
    for got, want in zip(*out):
        assert got.dtype == torch.bfloat16
        err = float((got.float() - want).abs().max().cpu())
        assert err <= 2.0 ** -7 * float(want.abs().max().cpu())


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_xentfn_bf16_gradients_match_fp32_autograd(tied, softcap):
    """In bf16 the backward recomputes the forward's fp32 logits, so its
    gradients are those of the fp32 function within two bf16 roundings
    (2^-7 of max |grad|)."""
    _bf16_grads_vs_fp32("cpu", tied, softcap)


def test_xentfn_backward_zero_on_invalid_rows():
    (_, (h, w, t, v)) = _inputs(40, 8, 128, 100, valid_frac=0.5)
    h.requires_grad_()
    nll = ops.xent(h, w, t, v, vocab=100)
    (dh,) = torch.autograd.grad(nll.sum(), (h,))
    assert float(dh[v == 0].abs().max()) == 0.0
    assert float(dh[v == 1].abs().sum(-1).min()) > 0.0


def test_splits_cover_the_vocabulary_and_fill_the_card():
    for n, vp in ((8188, 256000), (8188, 32000), (1000, 49280), (5, 100),
                  (1, 1)):
        s, tps = xent.splits(n, vp, 132)
        nvt = -(-vp // xent.BV)
        assert s * tps >= nvt and (s - 1) * tps < nvt
    # few rows: the vocabulary is split so that the blocks fill the SMs
    s, _ = xent.splits(1024, 32000, 132)
    assert (1024 // xent.BN) * s >= 132


def test_tc_splits_cover_the_vocabulary_and_fill_the_card():
    """The bf16 route's splits in its own tiles (128 rows x 256 columns,
    one 193 KB block a SM): they cover the vocabulary, and fill the card
    at the training shapes and with few rows."""
    bf16 = torch.bfloat16
    bn, bv, per_sm = xent.tiles(bf16)
    assert (bn, bv, per_sm) == (xent.TC_BN, xent.TC_BV, 1) == (128, 256, 1)
    assert xent.TC_SMEM == 197632 <= 232448
    assert xent.tiles(torch.float32) == (xent.BN, xent.BV,
                                         xent.BLOCKS_PER_SM)
    for n, vp in ((8188, 256000), (8188, 32000), (1000, 49280), (5, 100),
                  (1, 1)):
        s, tps = xent.splits(n, vp, 132, bf16)
        nvt = -(-vp // bv)
        assert s * tps >= nvt and (s - 1) * tps < nvt
    for n, vp in ((8188, 256000), (8188, 32000), (1024, 32000)):
        s, _ = xent.splits(n, vp, 132, bf16)
        assert 0.9 * 132 <= -(-n // bn) * s <= 132


def test_cpu_call_launches_nothing():
    (_, (h, w, t, _)) = _inputs(16, 8, 64, 64)
    before = dict(_build.LAUNCHES)
    ops.xent_rows(h, w, t)
    ops.fused_xent_mean(h[None], w, t[None])
    assert _build.LAUNCHES == before


def test_both_versions_refuse_the_same_shapes():
    h, w, t = torch.zeros(4, 8), torch.zeros(8, 16), torch.zeros(4).long()
    for fn in (ops.xent_rows, xent.xent_cuda):
        with pytest.raises(ValueError, match="must be"):
            fn(h, torch.zeros(7, 16), t)
        with pytest.raises(ValueError, match="targets"):
            fn(h, w, torch.zeros(4))
        with pytest.raises(ValueError, match="vocab"):
            fn(h, w, t, vocab=17)
        with pytest.raises(ValueError, match="dtypes"):
            fn(h, w.double(), t)


def test_kernel_wrapper_refuses_cpu_tensors():
    (_, (h, w, t, _)) = _inputs(16, 8, 64, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        xent.xent_cuda(h, w, t)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CUDA_CASES = [
    # n, d, vp, vocab, softcap, valid_frac, tied
    (1024, 256, 32000, 32000, 0.0, None, False),     # tinyllama's vocab
    (1000, 256, 32000, 32000, 0.0, None, True),      # ragged N, embed.T
    (1000, 128, 49280, 49155, 30.0, 0.5, False),     # granite's padding
    (77, 96, 300, 250, 0.0, 0.5, True),              # ragged everything
    (3, 8, 5, 5, 0.0, None, False),                  # one partial tile
]


def _check_cuda_case(case, dtype, dev, seed=0):
    """ops.xent_rows on the card against the plain version in fp32 from the
    same inputs: per row 1e-4 + 1e-4|want|, the sum at the JAX fp32 test's
    rtol 1e-4, masked rows exactly 0; one launch."""
    n, d, vp, vocab, softcap, valid_frac, tied = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    w = (torch.randn(vp, d, generator=gen, device=dev) * 0.1).to(dtype)
    w = w.T if tied else w.T.contiguous()
    t = torch.randint(0, vocab, (n,), generator=gen, device=dev)
    v = (None if valid_frac is None else
         (torch.rand(n, generator=gen, device=dev) < valid_frac).float())
    _build.reset_launches()
    nll, lse = ops.xent_rows(h, w, t, v, vocab=vocab, softcap=softcap)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["xent"] == 1
    want_nll, want_lse = ref.xent_rows(h.float(), w.float(), t, v, vocab,
                                       softcap)
    for got, want in ((nll, want_nll), (lse, want_lse)):
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    np.testing.assert_allclose(float(nll.sum()), float(want_nll.sum()),
                               rtol=1e-4)
    if v is not None:
        assert float(nll[v == 0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(case, dtype, cuda):
    """float32 runs the fp32-core kernel, bfloat16 the tensor-core one."""
    _check_cuda_case(case, dtype, cuda)


TC_CASES = [
    # n, d, vp, vocab, softcap, valid_frac, tied
    (1000, 72, 1000, 990, 0.0, None, False),       # ragged D and N
    (1000, 72, 1000, 990, 0.0, None, True),
    (300, 100, 515, 500, 30.0, 0.5, False),        # rows not 16-byte
    (300, 100, 515, 500, 30.0, 0.5, True),         # aligned: scalar copy
    (129, 64, 257, 257, 0.0, None, False),         # one row, one column over
    (2048, 1024, 32000, 32000, 0.0, None, True),   # many splits, embed.T
    (1000, 1536, 49280, 49155, 30.0, 0.5, True),   # granite's padding, tied
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES)
def test_cuda_tc_route_matches_plain(case, cuda):
    """The bf16 tensor-core kernel: both head layouts, ragged N, Vp and D
    (D not a multiple of the depth stage, rows not 16-byte aligned), the
    padded vocabulary with softcap and a valid mask."""
    _check_cuda_case(case, torch.bfloat16, cuda, seed=4)


@pytest.mark.cuda
def test_cuda_bf16_runs_the_tensor_core_kernel(cuda):
    """`ops.xent_rows` on bf16 CUDA tensors launches `xent_partial_tc`
    (and the merge of its splits); float32 launches `xent_partial`."""
    from torch.profiler import ProfilerActivity, profile

    for dtype, want in ((torch.bfloat16, "xent_partial_tc"),
                        (torch.float32, "xent_partial")):
        h = torch.randn(256, 64, device=cuda).to(dtype)
        w = torch.randn(64, 1000, device=cuda).to(dtype)
        t = torch.randint(0, 1000, (256,), device=cuda)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops.xent_rows(h, w, t)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        ours = [n for n in names if "xent_partial" in n]
        assert len(ours) == 1 and f"{want}<" in ours[0], names
        assert sum("xent_combine" in n for n in names) == 1, names


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True])
def test_cuda_xentfn_gradients_match_the_cpu(tied, cuda):
    """The same function on the card (kernel forward) and on the CPU
    (plain forward): loss and gradients, fp32."""
    gen = torch.Generator().manual_seed(1)
    h = torch.randn(700, 64, generator=gen)
    leaf = torch.randn(1000, 64, generator=gen) * 0.1
    t = torch.randint(0, 990, (700,), generator=gen)
    out = []
    for dev in ("cpu", cuda):
        hh = h.to(dev).requires_grad_()
        ll = (leaf if tied else leaf.T.contiguous()).to(dev).requires_grad_()
        nll = ops.xent(hh, ll.T if tied else ll, t.to(dev), vocab=990,
                       softcap=30.0)
        out.append([nll.sum().detach().cpu()] + [
            g.cpu() for g in torch.autograd.grad(nll.sum(), (hh, ll))])
    for c, g in zip(*out):
        assert float((c - g).abs().max()) <= 1e-4 * max(
            1.0, float(c.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True])
def test_cuda_xentfn_bf16_gradients_match_fp32_autograd(tied, cuda):
    """The kernel's lse normalises the backward's logits in bf16 too."""
    _bf16_grads_vs_fp32(cuda, tied, 30.0)


@pytest.mark.cuda
def test_cuda_raw_launcher_refuses_grad(cuda):
    h = torch.zeros(4, 8, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        xent.xent_cuda(h, torch.zeros(8, 16, device=cuda),
                       torch.zeros(4, dtype=torch.long, device=cuda))
