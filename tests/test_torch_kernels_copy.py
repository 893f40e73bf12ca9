"""PyTorch port of the copy stencil against the JAX package.

The same numpy inputs go through the JAX package's Pallas kernel
(`repro.kernels.copy_stencil.copy_stencil.copy_pallas`, interpret mode) and
through the port's `ops.copy_stencil` on the CPU (its plain version,
`src + zeros_like(src)`); bfloat16 crosses as `uint16` bits. A copy is
exact: the outputs are compared bit for bit. Both refuse the same inputs.
The `cuda` cases hold the CUDA kernel, which copies bytes, bitwise against
its input (-0.0 and NaN payloads included) and against the plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.copy_stencil.copy_stencil import copy_pallas
from repro_torch.kernels import _build
from repro_torch.kernels.copy_stencil import ops, ref
from repro_torch.kernels.copy_stencil.copy_stencil import copy_cuda
from repro_torch.weather import convert

CASES = [((64, 128), 16), ((256, 256), 64), ((512, 128), 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _pair(rng, shape, dtype):
    """The same input as a jax array and a CPU tensor, bit for bit."""
    src = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(dtype)
    return src, convert.tensor_from_numpy(np.asarray(src), "cpu")


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _np_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("shape,tr", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_copy_matches_pallas(shape, tr, dtype, rng):
    jsrc, tsrc = _pair(rng, shape, dtype)
    got = ops.copy_stencil(tsrc, tr=tr)
    assert got.dtype == tsrc.dtype and got.shape == tsrc.shape
    assert got.data_ptr() != tsrc.data_ptr()
    want = copy_pallas(jsrc, tr=tr, interpret=True)
    assert want.dtype == jsrc.dtype
    np.testing.assert_array_equal(_np_bits(convert.tensor_to_numpy(got)),
                                  _np_bits(want))


@pytest.mark.parametrize("shape,tr", [((64, 128), 48), ((100, 8), 256),
                                      ((4, 64, 64), 4)])
def test_both_packages_refuse_the_same_inputs(shape, tr, rng):
    jsrc, tsrc = _pair(rng, shape, "float32")
    with pytest.raises(ValueError) as want:
        copy_pallas(jsrc, tr=tr, interpret=True)
    with pytest.raises(ValueError) as got:
        ops.copy_stencil(tsrc, tr=tr)
    with pytest.raises(ValueError):
        copy_cuda(tsrc, tr=tr)
    if len(shape) == 2:
        assert str(got.value) == str(want.value)


def test_plain_version_adds_zeros():
    src = torch.tensor([[-0.0, 1.5, float("nan")]] * 4)
    out = ref.copy_stencil(src)
    assert torch.equal(out[:, :2], src[:, :2])
    assert not torch.signbit(out[0, 0])          # -0.0 + 0.0 is +0.0
    assert torch.isnan(out[:, 2]).all()


def test_cpu_call_launches_nothing(rng):
    _, src = _pair(rng, (256, 8), "float32")
    before = dict(_build.LAUNCHES)
    ops.copy_stencil(src)
    assert _build.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    _, src = _pair(rng, (256, 8), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        copy_cuda(src)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tr", CASES + [((7, 3), 1), ((256, 5), 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_cuda_kernel_copies_bits(shape, tr, dtype, cuda, rng):
    src = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    src = (src * 100).to(dtype).to(cuda)
    if dtype.is_floating_point:
        src[0, 0] = -0.0
    _build.reset_launches()
    got = ops.copy_stencil(src, tr=tr)
    assert _build.LAUNCHES["copy"] == 1
    torch.cuda.synchronize()
    assert got.dtype == src.dtype and got.data_ptr() != src.data_ptr()
    assert torch.equal(got.view(torch.uint8), src.view(torch.uint8))
    assert torch.equal(got, ref.copy_stencil(src))


@pytest.mark.cuda
def test_cuda_kernel_keeps_negative_zero_and_nan_payloads(cuda):
    payloads = np.array([0x7FC00001, 0xFFC12345, 0x7F800001, 0x80000000,
                         0x3F800000, 0x00000001] * 256, dtype=np.uint32)
    src = torch.from_numpy(payloads.view(np.float32)).reshape(256, 6).to(cuda)
    got = copy_cuda(src)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(src))
    # the plain version agrees up to NaN and the sign of zero
    plain = ref.copy_stencil(src)
    assert torch.equal(torch.nan_to_num(got, 1.0), torch.nan_to_num(plain, 1.0))


@pytest.mark.cuda
def test_cuda_kernel_on_unaligned_addresses(cuda):
    base = torch.arange(256 * 9 + 1, dtype=torch.float32, device=cuda)
    src = base[1:].view(256, 9)                   # 4 bytes past alignment
    assert src.data_ptr() % 16 != 0 and src.is_contiguous()
    got = copy_cuda(src)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(src))


# The kernel moves one 16 KB tile a block (256 threads, four 16-byte
# vectors each) and the bytes past the last whole vector one a thread:
# sizes at one tile, four tiles and a thousand, each +-1 and +-16 bytes,
# and sizes under one tile and under one vector.
TILE = 16 * 1024
BOUNDARY_SIZES = sorted({n + d for n in (TILE, 4 * TILE, 1000 * TILE)
                         for d in (-16, -1, 0, 1, 16)} | {1, 15, 16, 17, 100,
                                                          TILE // 2})


@pytest.mark.cuda
@pytest.mark.parametrize("nbytes", BOUNDARY_SIZES)
def test_cuda_kernel_at_chunk_and_stage_boundaries(nbytes, cuda):
    gen = torch.Generator(device=cuda).manual_seed(nbytes)
    src = torch.randint(0, 256, (1, nbytes), generator=gen, device=cuda,
                        dtype=torch.uint8)
    got = copy_cuda(src, tr=1)
    torch.cuda.synchronize()
    assert torch.equal(got, src)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64, torch.int8,
                                   torch.int32, torch.int64, torch.uint8,
                                   torch.bool])
def test_cuda_kernel_copies_every_dtype(dtype, cuda):
    n = 3 * TILE + 7                           # ragged in every element size
    raw = torch.randint(0, 256, (n * 8,), device=cuda, dtype=torch.uint8)
    if dtype == torch.bool:
        raw = raw % 2
    src = raw.view(dtype)[:n].reshape(1, n)
    got = copy_cuda(src, tr=1)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.uint8), src.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("src_off,dst_off", [(1, 0), (0, 1), (3, 3), (8, 4),
                                             (16, 16)])
@pytest.mark.parametrize("nbytes", [15, 4 * TILE + 1])
def test_cuda_kernel_on_unaligned_source_and_destination(src_off, dst_off,
                                                         nbytes, cuda):
    # The launcher takes any addresses; the wrapper always allocates an
    # aligned output, so the destination's offset is given here directly.
    gen = torch.Generator(device=cuda).manual_seed(src_off * 31 + dst_off)
    src = torch.randint(0, 256, (nbytes + 32,), generator=gen, device=cuda,
                        dtype=torch.uint8)
    dst = torch.zeros(nbytes + 32, device=cuda, dtype=torch.uint8)
    lib = _build.load()
    err = lib.nero_copy(src.data_ptr() + src_off, dst.data_ptr() + dst_off,
                        nbytes, _build.stream_of(src))
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(dst[dst_off:dst_off + nbytes],
                       src[src_off:src_off + nbytes])
    assert not dst[:dst_off].any() and not dst[dst_off + nbytes:].any()
