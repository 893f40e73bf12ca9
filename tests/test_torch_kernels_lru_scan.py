"""PyTorch port of the LRU-sweep kernel against the JAX package.

The same seeded numpy inputs go through the JAX package's Pallas kernel
(`lru_scan_pallas`, interpret mode) and its associative-scan oracle
(`lru_scan_ref`), and through the port's plain version on the CPU
(`ops.lru_scan`, a log-depth doubling scan in fp32), at the JAX kernel
test's 2e-5 (`tests/test_kernels_copy_scan.py`). The model's batched
(B, T, W) layout with a carried state goes through `models.rglru.lru_scan`
in both packages. The `cuda` cases hold the CUDA kernel (one thread per
channel, sequential in time, a and b staged through a shared-memory ring
filled by bulk copies or, for rows off 16 bytes, by each lane's plain loads)
against the plain version and against the recurrence taken one step at a
time, bit for bit, on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.lru_scan.lru_scan import lru_scan_pallas
from repro.kernels.lru_scan.ref import lru_scan_ref as jax_lru_scan_ref
from repro.models import rglru as jrglru
from repro_torch.kernels import _build
from repro_torch.kernels.lru_scan import ops, ref
from repro_torch.kernels.lru_scan.lru_scan import lru_scan_cuda
from repro_torch.models import rglru


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _ab(rng, shape):
    a = rng.uniform(0.3, 0.99, size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape,tiles", [((32, 64), (8, 32)),
                                         ((64, 128), (16, 128)),
                                         ((16, 32), (16, 16))])
def test_plain_version_matches_pallas_and_ref(shape, tiles, rng):
    a, b = _ab(rng, shape)
    got = ops.lru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    tt, tc = tiles
    kern = np.asarray(lru_scan_pallas(jnp.asarray(a), jnp.asarray(b), tt=tt,
                                      tc=tc, interpret=True))
    oracle = np.asarray(jax_lru_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, kern, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("t", [1, 2, 7, 33])
def test_batched_layout_with_carried_state(t, rng):
    """The model's call: (B, T, W) with h0 folded into the first step."""
    a, b = _ab(rng, (3, t, 16))
    h0 = rng.normal(size=(3, 16)).astype(np.float32)
    want = np.asarray(jrglru.lru_scan(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(h0)))
    got = rglru.lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(h0)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # against the step-by-step recurrence
    h = h0
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        np.testing.assert_allclose(got[:, i], h, rtol=2e-5, atol=2e-5)


def test_bf16_operands_scan_in_fp32(rng):
    a, b = _ab(rng, (40, 24))
    ta = torch.from_numpy(a).bfloat16()
    tb = torch.from_numpy(b).bfloat16()
    got = ops.lru_scan(ta, tb)
    assert got.dtype == torch.bfloat16
    want = ref.lru_scan_ref(ta.float(), tb.float())
    assert torch.equal(got, want.bfloat16())


def test_plain_version_refuses_mismatched_operands():
    a = torch.zeros(4, 8)
    for b in (torch.zeros(4, 9), torch.zeros(4, 8).double()):
        with pytest.raises(ValueError):
            ops.lru_scan(a, b)
    with pytest.raises(ValueError):
        ops.lru_scan(torch.zeros(8), torch.zeros(8))


def test_cpu_call_launches_nothing(rng):
    a, b = _ab(rng, (8, 16))
    before = dict(_build.LAUNCHES)
    ops.lru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert _build.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    a, b = _ab(rng, (8, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        lru_scan_cuda(torch.from_numpy(a), torch.from_numpy(b))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128), (4, 1024, 4096), (3, 1, 4096),
                                   (2, 13, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(shape, dtype, cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = (0.3 + 0.69 * torch.rand(shape, generator=gen, device=cuda)).to(dtype)
    b = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    _build.reset_launches()
    got = ops.lru_scan(a, b)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["lru_scan"] == 1
    assert got.dtype == dtype and got.shape == a.shape
    want = ref.lru_scan_ref(a.float(), b.float())
    # fp32: the JAX kernel test's 2e-5; bf16: the output's one rounding
    rtol = 2e-5 if dtype == torch.float32 else 2.0 ** -8 + 2e-5
    assert bool(((got.float() - want).abs()
                 <= 2e-5 + rtol * want.abs()).all())


@pytest.mark.cuda
def test_cuda_model_scan_with_carried_state(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = 0.3 + 0.69 * torch.rand(2, 5, 64, generator=gen, device=cuda)
    b = torch.randn(2, 5, 64, generator=gen, device=cuda)
    h0 = torch.randn(2, 64, generator=gen, device=cuda)
    got = rglru.lru_scan(a, b, h0)
    want = rglru.lru_scan(a.cpu(), b.cpu(), h0.cpu())
    torch.cuda.synchronize()
    assert float((got.cpu() - want).abs().max()) <= 2e-5


# ---------------------------------------------------------------------------
# the gradient: LruScanFn
# ---------------------------------------------------------------------------

def test_reverse_sweep_is_the_flipped_forward(rng):
    a, b = _ab(rng, (2, 9, 5))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = ops.sweep(ta, tb, reverse=True).numpy()
    h = np.zeros((2, 5), np.float32)
    for t in range(8, -1, -1):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(got[:, t], h, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("t", [1, 6, 33])
def test_lru_scan_fn_matches_jax_grad(with_h0, t, rng):
    """The model's `lru_scan` (h0 folded into the first step) through
    `LruScanFn` against `jax.grad` of the JAX model's associative scan:
    gradients of a, b and h0 for a weighted sum of h, fp32."""
    import jax

    a, b = _ab(rng, (2, t, 12))
    h0 = rng.normal(size=(2, 12)).astype(np.float32)
    cot = rng.normal(size=(2, t, 12)).astype(np.float32)
    args = (a, b, h0) if with_h0 else (a, b)

    def jloss(*xs):
        return (jrglru.lru_scan(*xs) * cot).sum()

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    xs = [torch.from_numpy(x).requires_grad_() for x in args]
    h = rglru.lru_scan(*xs)
    got = torch.autograd.grad((h * torch.from_numpy(cot)).sum(), xs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_lru_scan_fn_bf16_gradients_keep_the_dtype(rng):
    a, b = _ab(rng, (2, 7, 8))
    xs = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (a, b)]
    da, db = torch.autograd.grad(ops.lru_scan(*xs).float().sum(), xs)
    assert da.dtype == db.dtype == torch.bfloat16




@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1024, 4096), (2, 13, 100), (5, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_reverse_kernel_matches_flipped_plain(shape, dtype, cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = (0.3 + 0.69 * torch.rand(shape, generator=gen, device=cuda)).to(dtype)
    b = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    _build.reset_launches()
    got = lru_scan_cuda(a, b, reverse=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["lru_scan"] == 1
    want = ref.lru_scan_ref(a.float().flip(-2), b.float().flip(-2)).flip(-2)
    rtol = 2e-5 if dtype == torch.float32 else 2.0 ** -8 + 2e-5
    assert bool(((got.float() - want).abs()
                 <= 2e-5 + rtol * want.abs()).all())


@pytest.mark.cuda
def test_cuda_lru_scan_fn_gradients_match_the_cpu(cuda):
    gen = torch.Generator().manual_seed(4)
    a = 0.3 + 0.69 * torch.rand(2, 50, 96, generator=gen)
    b = torch.randn(2, 50, 96, generator=gen)
    h0 = torch.randn(2, 96, generator=gen)
    cot = torch.randn(2, 50, 96, generator=gen)
    out = []
    for dev in ("cpu", cuda):
        xs = [x.to(dev).requires_grad_() for x in (a, b, h0)]
        _build.reset_launches()
        h = rglru.lru_scan(*xs)
        grads = torch.autograd.grad((h * cot.to(dev)).sum(), xs)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert _build.LAUNCHES["lru_scan"] == 2    # forward, reverse
        out.append([g.cpu() for g in grads])
    for c, g in zip(*out):
        assert float((c - g).abs().max()) <= 2e-5 * max(
            1.0, float(c.abs().max()))


@pytest.mark.cuda
def test_cuda_raw_launcher_refuses_operands_that_need_grad(cuda):
    a = torch.zeros(4, 8, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        lru_scan_cuda(a, a.detach())


def test_one_kernel_and_one_launch_path():
    """`csrc/lru_scan.cu` holds one kernel, forward and reverse, for aligned
    and misaligned rows alike, launched from one place."""
    import re
    from pathlib import Path

    cu = re.sub(r"//[^\n]*", "", (Path(_build.CSRC) / "lru_scan.cu")
                .read_text())
    assert cu.count("__global__") == 1 and cu.count("<<<") == 1
    assert "cp.async.bulk" in cu and "mbarrier" in cu


def _misaligned(x):
    """`x`'s values in a tensor whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    off = (4 - buf.data_ptr() % 16) % 16 // x.element_size()
    view = buf[off:off + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def test_misaligned_copy_starts_off_16_bytes():
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.arange(30, dtype=dtype).reshape(5, 6)
        m = _misaligned(x)
        assert m.data_ptr() % 16 == 4 and torch.equal(m, x)
        assert m.is_contiguous()


def _sequential(a, b, reverse=False):
    """The recurrence one step at a time in fp32 (a product, then a sum,
    each rounded), the result in a's dtype."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(bf[..., 0, :])
    out = torch.empty_like(bf)
    steps = range(a.shape[-2] - 1, -1, -1) if reverse else range(a.shape[-2])
    for t in steps:
        h = af[..., t, :] * h + bf[..., t, :]
        out[..., t, :] = h
    return out.to(a.dtype)


@pytest.mark.parametrize("reverse", [False, True])
def test_sequential_loop_matches_the_plain_version(reverse, rng):
    a, b = (torch.from_numpy(x) for x in _ab(rng, (2, 37, 24)))
    want = ref.lru_scan_ref(a.flip(1), b.flip(1)).flip(1) if reverse \
        else ref.lru_scan_ref(a, b)
    torch.testing.assert_close(_sequential(a, b, reverse), want, atol=2e-5,
                               rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 77, 100), (1, 300, 4100), (3, 1, 4096),
                                   (2, 64, 96), (4, 129, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_kernel_is_the_sequential_recurrence(shape, dtype, reverse,
                                                  cuda):
    """The kernel, at T not a multiple of the ring's stage, C not a
    multiple of a block's 32 channels and T = 1, is the recurrence taken
    one step at a time, bit for bit; a misaligned copy of the operands
    fills the ring with plain loads and gives the same bits, in one launch
    too."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = (0.3 + 0.69 * torch.rand(shape, generator=gen, device=cuda)).to(dtype)
    b = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    _build.reset_launches()
    got = lru_scan_cuda(a, b, reverse=reverse)
    assert _build.LAUNCHES["lru_scan"] == 1
    assert torch.equal(got, _sequential(a, b, reverse))
    ma, mb = _misaligned(a), _misaligned(b)
    assert ma.data_ptr() % 16 and mb.data_ptr() % 16
    assert torch.equal(lru_scan_cuda(ma, mb, reverse=reverse), got)
    assert _build.LAUNCHES["lru_scan"] == 2
