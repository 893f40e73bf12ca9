"""PyTorch port of hdiff against the JAX package's Pallas kernel.

The same numpy inputs go through `repro.kernels.hdiff.hdiff.hdiff_pallas`
(interpret mode) and the port's `ops.hdiff` on the CPU (its plain version);
tolerances are the reference's own (`tests/test_kernels_hdiff.py`): 1e-5 in
float32, 0.15 in bfloat16. The inputs are white noise, not periodic, so the
2-wide passthrough ring is checked too. The `cuda` cases hold the CUDA
kernel against the plain version on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.hdiff.hdiff import hdiff_pallas
from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels.hdiff import ops, ref
from repro_torch.kernels.hdiff.hdiff import hdiff_cuda
from repro_torch.weather import convert

SHAPES = [(3, 8, 16), (4, 12, 8), (2, 16, 20)]
TOL = {"float32": 1e-5, "bfloat16": 0.15}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _pair(rng, shape, dtype):
    """The same input as a jax array and a CPU tensor, bit for bit."""
    src = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(dtype)
    return src, convert.tensor_from_numpy(np.asarray(src), "cpu")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_hdiff_matches_pallas(shape, dtype, rng):
    jsrc, tsrc = _pair(rng, shape, dtype)
    want = np.asarray(hdiff_pallas(jsrc, ty=4, interpret=True), np.float32)
    got = ops.hdiff(tsrc)
    assert got.dtype == tsrc.dtype and got.shape == tsrc.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_passes_through(dtype, rng):
    _, src = _pair(rng, (2, 9, 11), dtype)
    out = ref.hdiff(src)
    for sl in (np.s_[..., :2, :], np.s_[..., -2:, :], np.s_[..., :, :2],
               np.s_[..., :, -2:]):
        assert torch.equal(out[sl], src[sl])
    assert not torch.equal(out[..., 2:-2, 2:-2], src[..., 2:-2, 2:-2])


def test_leading_axes_are_independent_planes(rng):
    _, src = _pair(rng, (2, 3, 8, 10), "float32")
    out = ref.hdiff(src)
    assert torch.equal(out[1], ref.hdiff(src[1]))


def test_cpu_call_launches_nothing(rng):
    _, src = _pair(rng, (2, 8, 8), "float32")
    before = dict(_build.LAUNCHES)
    ops.hdiff(src)
    assert _build.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    _, src = _pair(rng, (2, 8, 8), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        hdiff_cuda(src)


def test_default_tile_fits_a_hopper_block():
    t = tiling.hdiff_tile(260, 260)
    assert t.threads <= tiling.MAX_THREADS_PER_BLOCK
    assert t.smem_bytes <= tiling.SMEM_BYTES_PER_BLOCK
    with pytest.raises(ValueError, match="threads"):
        tiling.hdiff_tile(260, 260, ty=64, tx=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype, cuda, rng):
    _, src = _pair(rng, (6, 37, 70), dtype)
    src = src.to(cuda)
    got = ops.hdiff(src)
    torch.cuda.synchronize()
    # The plain version in fp32 from the same inputs. A bf16 kernel computes
    # in fp32 too and rounds its output once: twice bf16's unit roundoff.
    want = ref.hdiff(src.float())
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    assert ((got.float() - want).abs() <= 1e-5 + rtol * want.abs()).all()
    other = hdiff_cuda(src, tile=tiling.hdiff_tile(37, 70, ty=4, tx=64))
    assert torch.equal(other, got)
