"""PyTorch port of the k-step hdiff round against the JAX package's kernel.

The same numpy inputs go through `repro.kernels.hdiff.hdiff.
hdiff_kstep_pallas` (interpret mode) and the port's `ops.hdiff_kstep` on the
CPU (its plain version, `ref.hdiff_kstep`); tolerances are the reference's
hdiff ones (`tests/test_kernels_hdiff.py`): 1e-5 in float32, 0.15 in
bfloat16. The `cuda` cases hold the CUDA kernel against k `hdiff_cuda`
launches, bit for bit in both dtypes, and against the plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.hdiff.hdiff import hdiff_kstep_pallas
from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels.hdiff import ops, ref
from repro_torch.kernels.hdiff.hdiff import hdiff_cuda, hdiff_kstep_cuda
from repro_torch.weather import convert

SHAPE = (3, 12, 16)      # (planes, ny, nx); ty = 6 holds k <= 3
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


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kstep_matches_pallas(k, dtype, rng):
    jsrc, tsrc = _pair(rng, SHAPE, dtype)
    want = np.asarray(hdiff_kstep_pallas(jsrc, ty=6, k_steps=k,
                                         interpret=True), np.float32)
    got = ops.hdiff_kstep(tsrc, k=k)
    assert got.dtype == tsrc.dtype and got.shape == tsrc.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kstep_is_k_plain_steps(k, dtype, rng):
    _, src = _pair(rng, SHAPE, dtype)
    want = src
    for _ in range(k):
        want = ref.hdiff(want)
    assert torch.equal(ref.hdiff_kstep(src, k=k), want)


def test_kstep_ring_passes_through(rng):
    _, src = _pair(rng, (2, 9, 11), "float32")
    out = ref.hdiff_kstep(src, k=3)
    for sl in (np.s_[..., :2, :], np.s_[..., -2:, :], np.s_[..., :, :2],
               np.s_[..., :, -2:]):
        assert torch.equal(out[sl], src[sl])


def test_cpu_call_launches_nothing(rng):
    _, src = _pair(rng, (2, 12, 12), "float32")
    before = dict(_build.LAUNCHES)
    ops.hdiff_kstep(src, k=2)
    assert _build.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    _, src = _pair(rng, (2, 12, 12), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        hdiff_kstep_cuda(src, k_steps=2)


def test_default_tile_fits_a_hopper_block():
    for k in (1, 2, 3):
        t = tiling.hdiff_kstep_tile(256 + 4 * k, 256 + 4 * k, k)
        assert t.threads <= tiling.KSTEP_THREADS
        assert t.smem_bytes == 2 * 4 * (t.ty + 4 * k) * (t.tx + 4 * k)
        assert t.smem_bytes <= tiling.SMEM_BYTES_PER_BLOCK
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tiling.hdiff_kstep_tile(260, 260, 2, ty=160, tx=256)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_is_k_launches(k, dtype, cuda, rng):
    _, src = _pair(rng, (6, 37, 70), dtype)
    src = src.to(cuda)
    _build.reset_launches()
    got = ops.hdiff_kstep(src, k=k)
    assert _build.LAUNCHES["hdiff_kstep"] == 1
    chained = src
    for _ in range(k):
        chained = hdiff_cuda(chained)
    torch.cuda.synchronize()
    assert torch.equal(got, chained)
    # The plain version rounds through the storage dtype after each step as
    # the kernel does: 1e-5, plus one bf16 rounding (2^-7 relative).
    want = ref.hdiff_kstep(src, k=k).float()
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    assert ((got.float() - want).abs() <= 1e-5 + rtol * want.abs()).all()
    other = hdiff_kstep_cuda(src, k_steps=k,
                             tile=tiling.hdiff_kstep_tile(37, 70, k, ty=4,
                                                          tx=64))
    assert torch.equal(other, got)
