"""PyTorch port of upwind advection (hadv) against the JAX package.

The same numpy inputs go through the JAX package's plain version
(`repro.kernels.hadv.ref.hadv_upwind`) and its Pallas kernel
(`repro.kernels.hadv.hadv.hadv_pallas`, interpret mode), and through the
port's `ops.hadv_upwind` on the CPU (its plain version). Both compute in
float32 in the same operation order and round once to the storage dtype:
float32 within 1e-6, bfloat16 within 1e-6 + 2^-7·|want| (one rounding). The
periodic plain version (`ref.hadv_periodic`) is held against both on the
input wrap-padded by one row and column on the low sides, then cropped:
bit for bit against the JAX reference, whose order it keeps, and within
the same limits against the Pallas kernel, whose interpret mode contracts
`c - cfl * (...)` into a fused multiply-add on the CPU (one float32 ulp).
The `cuda` cases hold the CUDA kernel against the plain versions on the
card, in both boundary modes.
"""

import re
from pathlib import Path

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
    assert t.threads <= tiling.MAX_THREADS_PER_BLOCK
    assert 0 < t.smem_bytes <= tiling.SMEM_BYTES_PER_BLOCK
    with pytest.raises(ValueError, match="threads"):
        tiling.hadv_tile(257, 257, tx=256)      # fp32: 4 columns a lane


@pytest.mark.parametrize("itemsize,nx,strip", [
    (4, 256, 128), (4, 257, 86), (2, 256, 256), (2, 257, 129),
    (4, 70, 70), (2, 37, 37)])
def test_tile_balances_strips_and_segments(itemsize, nx, strip):
    """A warp holds 16 bytes a lane of a row: strips are balanced within
    that, so no warp is mostly idle at 256 or 257 columns; segments of at
    most HADV_SEGMENT rows, balanced."""
    t = tiling.hadv_tile(nx, nx, itemsize)
    assert t.tx == strip and t.threads == 32 * tiling.HADV_WARPS
    assert t.tx * itemsize <= 32 * 16
    segs = -(-nx // t.ty)
    assert t.ty <= tiling.HADV_SEGMENT and -(-nx // segs) == t.ty
    assert t.smem_bytes == tiling.hadv_smem(strip, itemsize) == \
        tiling.HADV_WARPS * tiling.HADV_RING * (
            tiling.ring_region(strip + 1, itemsize) + 16)


def _padded(jsrc):
    """`jsrc` (planes, ny, nx) wrap-padded by one row and one column on the
    low sides, as the JAX package's packed exchange leaves it."""
    p = jnp.concatenate([jsrc[:, -1:, :], jsrc], axis=1)
    return jnp.concatenate([p[:, :, -1:], p], axis=2)


@pytest.mark.parametrize("shape", [(3, 7, 8), (2, 15, 12), (4, 3, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_periodic_matches_padded_reference(shape, dtype, rng):
    jsrc, tsrc = _pair(rng, shape, dtype)
    got = ops.hadv_upwind(tsrc, cfl=0.3, periodic=True)
    assert got.dtype == tsrc.dtype and got.shape == tsrc.shape
    assert torch.equal(got, ref.hadv_periodic(tsrc, cfl=0.3))
    want = np.asarray(jref.hadv_upwind(_padded(jsrc), cfl=0.3)[:, 1:, 1:])
    np.testing.assert_array_equal(convert.tensor_to_numpy(got),
                                  want.view(np.uint16) if dtype == "bfloat16"
                                  else want)
    ty = max(t for t in (1, 2, 4) if (shape[1] + 1) % t == 0)
    pallas = hadv_pallas(_padded(jsrc), cfl=0.3, ty=ty, interpret=True)
    _assert_close(got, pallas[:, 1:, 1:], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_periodic_is_pad_passthrough_crop(dtype, rng):
    _, src = _pair(rng, (3, 9, 11), dtype)
    pad = torch.cat([src[:, -1:, :], src], dim=1)
    pad = torch.cat([pad[:, :, -1:], pad], dim=2)
    want = ref.hadv_upwind(pad)[:, 1:, 1:]
    assert torch.equal(ref.hadv_periodic(src), want)
    assert not torch.equal(ref.hadv_periodic(src)[:, :1], src[:, :1])


def test_one_kernel_two_modes_and_the_c_signature():
    """`csrc/hadv.cu` holds one kernel, launched from one place, for both
    boundary modes (a launch argument), loading rows by 16-byte copies; the
    ctypes signature has the C prototype's arguments."""
    cu = (Path(_build.CSRC) / "hadv.cu").read_text()
    code = re.sub(r"//[^\n]*", "", cu)
    assert code.count("__global__") == 1 and code.count("<<<") == 1
    assert "nero::copy_chunk(" in code and "int periodic" in code
    ring = (Path(_build.CSRC) / "warp_ring.cuh").read_text()
    assert "cp.async.cg.shared.global [%0], [%1], 16, %2;" in ring
    entry = code[code.index('extern "C" int nero_hadv('):]
    entry = entry[entry.index("(") + 1:entry.index(")")]
    names = [re.split(r"[\s*]+", a.strip())[-1] for a in entry.split(",")]
    assert names[-3:] == ["periodic", "bf16", "stream"]
    assert len(names) == len(_build._SIGNATURES["nero_hadv"])


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


# odd and ragged planes; bf16 rows of 74 and 514 bytes, off 16 bytes
CUDA_SHAPES = [(5, 37, 70), (3, 257, 257), (2, 8, 37), (4, 33, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_both_modes(shape, dtype, cuda, rng):
    """Both modes against their plain versions (in fp32 from the same
    inputs), at the plain version's bits in fp32; the periodic mode equal
    to pad + passthrough + crop on the card, bit for bit; two tilings that
    differ in strip width and segment height equal bit for bit."""
    _, src = _pair(rng, shape, dtype)
    src = src.to(cuda)
    _, ny, nx = shape
    isz = src.element_size()
    for periodic, plain in ((False, ref.hadv_upwind),
                            (True, ref.hadv_periodic)):
        got = hadv_cuda(src, periodic=periodic)
        torch.cuda.synchronize()
        want = plain(src.float())
        if dtype == "float32":
            assert torch.equal(got, want)
        assert ((got.float() - want).abs()
                <= 1e-6 + RTOL[dtype] * want.abs()).all()
        narrow = tiling.hadv_tile(ny, nx, isz, ty=5, tx=max(1, nx // 3))
        assert narrow.tx != tiling.hadv_tile(ny, nx, isz).tx or nx < 3
        assert torch.equal(hadv_cuda(src, tile=narrow, periodic=periodic),
                           got)
    pad = torch.cat([src[:, -1:, :], src], dim=1)
    pad = torch.cat([pad[:, :, -1:], pad], dim=2).contiguous()
    assert torch.equal(hadv_cuda(src, periodic=True),
                       hadv_cuda(pad)[:, 1:, 1:])


@pytest.mark.cuda
def test_cuda_kernel_reads_a_view_off_16_bytes(cuda, rng):
    """A stack that starts 2 bytes past a 16-byte boundary (bf16)."""
    _, src = _pair(rng, (3, 20, 37), "bfloat16")
    buf = torch.empty(src.numel() + 8, dtype=src.dtype, device=cuda)
    off = (2 - buf.data_ptr() % 16) % 16 // 2
    view = buf[off:off + src.numel()].view(src.shape)
    view.copy_(src)
    for periodic in (False, True):
        assert torch.equal(hadv_cuda(view, periodic=periodic),
                           hadv_cuda(src.to(cuda), periodic=periodic))
