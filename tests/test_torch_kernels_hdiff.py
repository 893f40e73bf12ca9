"""PyTorch port of hdiff against the JAX package's Pallas kernel.

The same numpy inputs go through `repro.kernels.hdiff.hdiff.hdiff_pallas`
(interpret mode) and the port's `ops.hdiff` on the CPU (its plain version);
tolerances are the reference's own (`tests/test_kernels_hdiff.py`): 1e-5 in
float32, 0.15 in bfloat16. The inputs are white noise, not periodic, so the
2-wide passthrough ring is checked too. The periodic mode's plain version
is held against the padded passthrough step cropped, and against the JAX
package's periodic hdiff. The `cuda` cases hold the CUDA
kernel against the plain version on the card, and its periodic mode bit
for bit against the passthrough launch on the wrap-padded stack, cropped.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.hdiff.hdiff import hdiff_pallas
from repro.weather.dycore import hdiff_periodic as jax_hdiff_periodic
from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels.dycore_fused.ref import pad_periodic
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


PERIODIC_SHAPES = [(3, 8, 16), (2, 5, 5), (2, 2, 2), (3, 3, 7), (2, 4, 9, 6)]


@pytest.mark.parametrize("shape", PERIODIC_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_periodic_matches_the_padded_step(shape, dtype, rng):
    """`ops.hdiff(periodic=True)` on the CPU is `pad_periodic`, the plain
    passthrough step and the crop bit for bit, and the JAX package's
    periodic hdiff within the reference's tolerance: a new contiguous
    tensor of the input's shape and dtype in which every point moves."""
    jsrc, src = _pair(rng, shape, dtype)
    got = ops.hdiff(src, periodic=True)
    assert got.dtype == src.dtype and got.shape == src.shape
    assert got.is_contiguous()
    ny, nx = shape[-2:]
    assert torch.equal(got, ref.hdiff(pad_periodic(src, 2))[
        ..., 2:2 + ny, 2:2 + nx])
    want = np.asarray(jax_hdiff_periodic(jsrc, ref.DEFAULT_COEFF),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])
    if shape[-1] > 4 and shape[-2] > 4:
        assert not torch.equal(got[..., :2, :], src[..., :2, :])
        assert not torch.equal(got[..., :, -2:], src[..., :, -2:])


def test_plain_periodic_wraps_the_plane(rng):
    """A plane rolled by (3, 5) steps to the same plane rolled: no point
    is an edge."""
    _, src = _pair(rng, (2, 9, 11), "float32")
    rolled = torch.roll(src, (3, 5), dims=(-2, -1))
    assert torch.equal(ref.hdiff_periodic(rolled),
                       torch.roll(ref.hdiff_periodic(src), (3, 5),
                                  dims=(-2, -1)))


def test_periodic_tile_holds_the_wrap_area():
    """The periodic mode's tile: the passthrough window, and HDIFF_WRAP
    bytes of shared memory more a ring row."""
    for ny, nx in ((390, 582), (256, 256), (5, 5)):
        t = tiling.hdiff_tile(ny, nx, periodic=True)
        one = tiling.hdiff_tile(ny, nx)
        assert (t.ty, t.tx, t.threads) == (one.ty, one.tx, one.threads)
        assert t.smem_bytes == one.smem_bytes + \
            tiling.HDIFF_WRAP * tiling.HDIFF_RING == \
            tiling.hdiff_stream_smem(1, t.threads, periodic=True)


def test_cpu_call_launches_nothing(rng):
    _, src = _pair(rng, (2, 8, 8), "float32")
    before = dict(_build.LAUNCHES)
    ops.hdiff(src)
    ops.hdiff(src, periodic=True)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("periodic", [False, True])
def test_kernel_wrapper_refuses_cpu_tensors(periodic, rng):
    _, src = _pair(rng, (2, 8, 8), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        hdiff_cuda(src, periodic=periodic)


def test_default_tile_fits_a_hopper_block():
    # The stream's tile: 5 balanced strips of 52 columns and 4 segments of
    # 65 rows of a 260 x 260 plane; a thread for each 2 columns of a strip,
    # its 2-column halo either side and 1 column of alignment slack (57, so
    # one warp); a ring of input rows.
    t = tiling.hdiff_tile(260, 260)
    assert (t.ty, t.tx, t.threads) == (65, 52, 32)
    assert t.smem_bytes == tiling.hdiff_stream_smem(1, t.threads)
    assert t.threads <= tiling.MAX_THREADS_PER_BLOCK
    assert t.smem_bytes <= tiling.SMEM_BYTES_PER_BLOCK
    with pytest.raises(ValueError, match="threads"):
        tiling.hdiff_tile(260, 2100, tx=2100)      # 2105 columns a block


@pytest.mark.parametrize("nx,k,want", [(260, 1, 52), (264, 2, 53),
                                       (268, 3, 268), (70, 1, 35),
                                       (5, 1, 5), (260, 3, 260)])
def test_default_strip_needs_fewest_threads(nx, k, want):
    """The default strip: the balanced split whose blocks hold the fewest
    threads for a row (idle columns of a block's last warp count), the
    narrowest on ties."""
    assert tiling.hdiff_strip(nx, k) == want

    def threads_a_row(width):
        return -(-nx // width) * tiling.hdiff_kstep_tile(
            8, nx, k, tx=width).threads
    widths = {tiling.balanced(nx, m) for m in range(8, nx + 1)} | {nx}
    assert threads_a_row(want) == min(threads_a_row(w) for w in widths)


@pytest.mark.parametrize("n,most,want", [(260, 96, 87), (260, 130, 130),
                                         (260, 129, 87), (260, 1, 1),
                                         (260, 400, 260), (37, 16, 13),
                                         (5, 2, 2), (264, 96, 88)])
def test_strips_are_balanced(n, most, want):
    """The fewest parts of at most `most`, differing by at most one: never
    a sliver beside wide strips."""
    assert tiling.balanced(n, most) == want
    parts = -(-n // want)
    widths = [(p + 1) * n // parts - p * n // parts for p in range(parts)]
    assert sum(widths) == n and max(widths) == want
    assert max(widths) - min(widths) <= 1


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("ny,nx,ty,tx", [(260, 260, 65, 96), (37, 70, 8, 32),
                                         (5, 6, 2, 3), (6, 5, 260, 260),
                                         (268, 268, 268, 140)])
def test_stream_tile_geometry(k, ny, nx, ty, tx):
    t = tiling.hdiff_kstep_tile(ny, nx, k, ty=ty, tx=tx)
    assert t.ty == tiling.balanced(ny, ty) <= min(ty, ny)
    assert t.tx == tiling.balanced(nx, tx) <= min(tx, nx)
    # whole warps of threads that own HDIFF_COLS columns each, enough for
    # the strip, its 2k-column halo either side and HDIFF_COLS - 1 columns
    # of alignment slack, and no spare warp
    need = t.tx + 4 * k + tiling.HDIFF_COLS - 1
    w = tiling.HDIFF_COLS * t.threads
    assert t.threads % 32 == 0
    assert need <= w < need + 32 * tiling.HDIFF_COLS
    ring = tiling.HDIFF_RING
    assert t.smem_bytes == 4 * (w + 8) * (2 * k + 4 * (k - 1) + ring) + 8 * ring
    assert t.smem_bytes <= tiling.SMEM_BYTES_PER_BLOCK


def test_stream_tile_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="stages"):
        tiling.hdiff_kstep_tile(64, 64, 0)
    with pytest.raises(ValueError, match="stages"):
        tiling.hdiff_kstep_tile(64, 64, 2.0)
    with pytest.raises(ValueError, match="threads"):
        tiling.hdiff_kstep_tile(260, 2100, 5, tx=2100)   # 2113 columns
    # so the widest block at the most stages a launch runs fits
    assert tiling.hdiff_stream_smem(tiling.HDIFF_MAX_K, 1024) <= \
        tiling.SMEM_BYTES_PER_BLOCK


@pytest.mark.parametrize("k,want", [(1, [1]), (3, [3]), (4, [2, 2]),
                                    (5, [2, 3]), (9, [3, 3, 3]),
                                    (10, [2, 2, 3, 3])])
def test_long_round_runs_even_launches(k, want):
    """A round of more than HDIFF_MAX_K steps runs as the fewest launches
    of at most HDIFF_MAX_K stages, as even as can be, on the tile of the
    largest."""
    assert tiling.hdiff_launches(k) == want
    assert tiling.hdiff_kstep_tile(292, 292, k) == \
        tiling.hdiff_kstep_tile(292, 292, max(want))


def _cuda_matches_plain(src, tile_b):
    """The kernel on its default tile against the plain version in fp32
    from the same inputs (a bf16 kernel computes in fp32 too and rounds its
    output once: twice bf16's unit roundoff), and on `tile_b` bit for
    bit."""
    got = ops.hdiff(src)
    torch.cuda.synchronize()
    want = ref.hdiff(src.float())
    rtol = 0.0 if src.dtype == torch.float32 else 2.0 ** -7
    assert ((got.float() - want).abs() <= 1e-5 + rtol * want.abs()).all()
    assert torch.equal(hdiff_cuda(src, tile=tile_b), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype, cuda, rng):
    _, src = _pair(rng, (6, 37, 70), dtype)
    tile_b = tiling.hdiff_tile(37, 70, ty=4, tx=24)
    assert tile_b.tx != tiling.hdiff_tile(37, 70).tx   # 3 strips, not 2
    _cuda_matches_plain(src.to(cuda), tile_b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 40), (3, 6, 40), (3, 40, 5),
                                   (3, 40, 6), (2, 5, 5)])
def test_cuda_small_planes(shape, dtype, cuda, rng):
    """Planes of 5 and 6 rows or columns, where the ring and the halo are
    most of the plane; one-row segments and strips of 2 as the second
    tiling."""
    _, src = _pair(rng, shape, dtype)
    _cuda_matches_plain(src.to(cuda),
                        tiling.hdiff_tile(shape[1], shape[2], ty=1, tx=2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nx", [70, 260, 264, 69])
def test_cuda_row_strides(nx, dtype, cuda, rng):
    """bf16 rows of 140 and 520 bytes are not 16-byte multiples, of 528
    bytes they are, of 138 every other row starts off 4 bytes; odd strips
    start off 4 bytes too. Also a view that starts one element into its
    storage."""
    _, src = _pair(rng, (3, 21, nx), dtype)
    src = src.to(cuda)
    _cuda_matches_plain(src, tiling.hdiff_tile(21, nx, ty=7, tx=nx // 3 - 1))
    view = src.reshape(-1)[1:1 + 2 * 21 * nx].view(2, 21, nx)
    assert view.data_ptr() != src.data_ptr() and view.is_contiguous()
    assert torch.equal(hdiff_cuda(view), hdiff_cuda(view.clone()))


def _periodic_matches_padded(src, tile=None):
    """The periodic launch (default tile, and `tile`) bit for bit against
    the passthrough launch on the wrap-padded stack, cropped to the
    interior; the plain periodic version in fp32 from the same inputs
    within twice bf16's unit roundoff in bf16. One launch a call."""
    ny, nx = src.shape[-2:]
    want = hdiff_cuda(pad_periodic(src, 2))[..., 2:2 + ny, 2:2 + nx]
    before = _build.LAUNCHES["hdiff"]
    got = hdiff_cuda(src, periodic=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["hdiff"] == before + 1
    assert got.is_contiguous() and got.shape == src.shape
    assert torch.equal(got, want)
    plain = ref.hdiff_periodic(src.float())
    rtol = 0.0 if src.dtype == torch.float32 else 2.0 ** -7
    assert ((got.float() - plain).abs() <= 1e-5 + rtol * plain.abs()).all()
    if tile is not None:
        assert torch.equal(hdiff_cuda(src, tile=tile, periodic=True), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_periodic_cosmo_e_planes(dtype, cuda, rng):
    """cosmo_e's 390 x 582 planes at the default tile (6 segments of 65
    rows, 10 ragged strips of 58 and 59 columns), and one segment of one
    strip as the second tiling, so both wraps of both axes fall in one
    block."""
    _, src = _pair(rng, (2, 390, 582), dtype)
    t = tiling.hdiff_tile(390, 582, periodic=True)
    assert (t.ty, t.tx) == (65, 59) and 582 % t.tx
    one = tiling.hdiff_tile(390, 582, ty=390, tx=582, periodic=True)
    assert (one.ty, one.tx) == (390, 582)
    _periodic_matches_padded(src.to(cuda), one)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,request_", [
    ((3, 37, 70), (37, 70)),      # a single segment of a single strip
    ((6, 37, 70), (4, 24)),       # 10 segments of 3 strips
    ((3, 5, 5), (1, 2)),          # one-row segments, strips of 2 and 1
    ((3, 5, 6), (5, 6)),
    ((3, 6, 5), (2, 3)),
    ((2, 2, 2), (1, 1)),          # the wrap reaches a whole period
    ((2, 3, 4), (3, 4))])
def test_cuda_periodic_tiles_and_small_planes(shape, request_, dtype, cuda,
                                              rng):
    """Small planes, where a block's window wraps on both sides or past a
    neighbour strip's columns, and several tilings."""
    _, src = _pair(rng, shape, dtype)
    tile = tiling.hdiff_tile(shape[1], shape[2], *request_, periodic=True)
    _periodic_matches_padded(src.to(cuda), tile)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nx", [70, 260, 264, 69, 582])
def test_cuda_periodic_row_strides(nx, dtype, cuda, rng):
    """bf16 rows of 140, 520 and 1164 bytes are not 16-byte multiples (of
    138 every other row starts off 4 bytes), so the wrap's chunks fall at
    every offset; three strips as the second tiling; a view that starts one
    element into its storage."""
    _, src = _pair(rng, (3, 21, nx), dtype)
    src = src.to(cuda)
    _periodic_matches_padded(
        src, tiling.hdiff_tile(21, nx, ty=7, tx=nx // 3 + 1, periodic=True))
    view = src.reshape(-1)[1:1 + 2 * 21 * nx].view(2, 21, nx)
    assert view.data_ptr() != src.data_ptr() and view.is_contiguous()
    _periodic_matches_padded(view)
