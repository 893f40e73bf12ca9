"""PyTorch port of upwind advection (hadv) against the JAX package.

The same numpy inputs go through the JAX package's plain version
(`repro.kernels.hadv.ref.hadv_upwind`) and its Pallas kernel
(`repro.kernels.hadv.hadv.hadv_pallas`, interpret mode), and through the
port's `ops.hadv_upwind` on the CPU (its plain version). Both compute in
float32 in the same operation order and round once to the storage dtype:
float32 within 1e-6, bfloat16 within 1e-6 + 2^-7·|want| (one rounding). The
`cuda` cases hold the CUDA kernel against the plain version on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.hadv import ref as jref
from repro.kernels.hadv.hadv import hadv_pallas
from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels.hadv import ops, ref
from repro_torch.kernels.hadv.hadv import hadv_cuda
from repro_torch.weather import convert

SHAPES = [(3, 8, 16), (4, 12, 8), (2, 16, 20)]
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _pair(rng, shape, dtype):
    """The same input as a jax array and a CPU tensor, bit for bit."""
    src = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(dtype)
    return src, convert.tensor_from_numpy(np.asarray(src), "cpu")


def _assert_close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert (np.abs(got - want) <= 1e-6 + RTOL[dtype] * np.abs(want)).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_hadv_matches_reference_ref(shape, dtype, rng):
    jsrc, tsrc = _pair(rng, shape, dtype)
    got = ops.hadv_upwind(tsrc)
    assert got.dtype == tsrc.dtype and got.shape == tsrc.shape
    _assert_close(got, jref.hadv_upwind(jsrc), dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_hadv_matches_pallas(shape, dtype, rng):
    jsrc, tsrc = _pair(rng, shape, dtype)
    _assert_close(ops.hadv_upwind(tsrc, cfl=0.3),
                  hadv_pallas(jsrc, cfl=0.3, ty=4, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_low_ring_passes_through(dtype, rng):
    _, src = _pair(rng, (2, 9, 11), dtype)
    out = ref.hadv_upwind(src)
    assert torch.equal(out[..., :1, :], src[..., :1, :])
    assert torch.equal(out[..., :, :1], src[..., :, :1])
    assert not torch.equal(out[..., 1:, 1:], src[..., 1:, 1:])


def test_cpu_call_launches_nothing(rng):
    _, src = _pair(rng, (2, 8, 8), "float32")
    before = dict(_build.LAUNCHES)
    ops.hadv_upwind(src)
    assert _build.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    _, src = _pair(rng, (2, 8, 8), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        hadv_cuda(src)


def test_default_tile_fits_a_hopper_block():
    t = tiling.hadv_tile(257, 257)
    assert t.threads <= tiling.MAX_THREADS_PER_BLOCK and t.smem_bytes == 0
    with pytest.raises(ValueError, match="threads"):
        tiling.hadv_tile(257, 257, ty=64, tx=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype, cuda, rng):
    _, src = _pair(rng, (6, 37, 70), dtype)
    src = src.to(cuda)
    _build.reset_launches()
    got = ops.hadv_upwind(src)
    assert _build.LAUNCHES["hadv"] == 1
    torch.cuda.synchronize()
    want = ref.hadv_upwind(src.float())
    assert ((got.float() - want).abs()
            <= 1e-5 + RTOL[dtype] * want.abs()).all()
    assert torch.equal(got[..., :1, :], src[..., :1, :])
    assert torch.equal(got[..., :, :1], src[..., :, :1])
    other = hadv_cuda(src, tile=tiling.hadv_tile(37, 70, ty=4, tx=64))
    assert torch.equal(other, got)
