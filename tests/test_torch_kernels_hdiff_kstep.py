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
from repro.weather.program import StencilProgram as JProgram
from repro.weather.program import compile as jcompile
from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels.hdiff import ops, ref
from repro_torch.kernels.hdiff.hdiff import hdiff_cuda, hdiff_kstep_cuda
from repro_torch.weather import convert, fields
from repro_torch.weather.program import StencilProgram, compile

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
    # The stream's tile at k stages: a thread for each HDIFF_COLS columns
    # of the widest strip, its 2k-column halo either side and HDIFF_COLS -
    # 1 columns of alignment slack, in whole warps; in rows of the block's
    # columns, two fp32 laplacian rows a stage, four output rows a stage but
    # the last and the ring's input rows, and an mbarrier a ring row.
    for k in (1, 2, 3):
        t = tiling.hdiff_kstep_tile(256 + 4 * k, 256 + 4 * k, k)
        need = t.tx + 4 * k + tiling.HDIFF_COLS - 1
        w = tiling.HDIFF_COLS * t.threads
        assert t.threads % 32 == 0
        assert need <= w < need + 32 * tiling.HDIFF_COLS
        assert t.threads <= tiling.MAX_THREADS_PER_BLOCK
        ring = tiling.HDIFF_RING
        assert t.smem_bytes == 4 * (w + 8) * (6 * k - 4 + ring) + 8 * ring
        assert t.smem_bytes <= tiling.SMEM_BYTES_PER_BLOCK
    with pytest.raises(ValueError, match="threads"):
        tiling.hdiff_kstep_tile(260, 2100, 3, tx=2100)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_kstep_tile_is_the_stream_tile_at_k_stages(k):
    """One routine: on the same segments and strips the k-step tile differs
    from the one-step tile only by the 4k halo columns its threads cover
    and its stages' rows; its defaults are k times the segment and the
    strip `hdiff_strip` picks for k stages."""
    one = tiling.hdiff_tile(260, 260, ty=65, tx=52)
    t = tiling.hdiff_kstep_tile(260, 260, k, ty=65, tx=52)
    assert (t.ty, t.tx) == (one.ty, one.tx)
    assert t.threads == 32 * -(-(52 + 4 * k + tiling.HDIFF_COLS - 1)
                               // (32 * tiling.HDIFF_COLS))
    if k == 1:
        assert (t.threads, t.smem_bytes) == (one.threads, one.smem_bytes)
    d = tiling.hdiff_kstep_tile(260, 260, k)
    assert d.ty == tiling.balanced(260, k * tiling.HDIFF_SEGMENT)
    assert d.tx == tiling.hdiff_strip(260, k)


def test_long_round_compiles_as_the_reference(rng):
    """An hdiff k-step program of more steps than one launch takes
    compiles, as the reference's does, on the tile of its largest launch,
    and its round is 9 plain steps."""
    kw = dict(grid_shape=(2, 40, 40), ensemble=1, op="hdiff",
              variant="kstep", k_steps=9)
    jplan = jcompile(JProgram(**kw))
    plan = compile(StencilProgram(**kw), device="cpu")
    assert (plan.variant, plan.k_steps) == (jplan.variant, jplan.k_steps)
    assert plan.tile == tiling.hdiff_kstep_tile(76, 76, tiling.HDIFF_MAX_K)
    st = fields.initial_state(torch.Generator().manual_seed(0), (2, 40, 40),
                              1, device="cpu")
    one = compile(StencilProgram(**dict(kw, variant="whole_state",
                                        k_steps=1)), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        plan.run(st, plan.k_steps).fields.values(),
        one.run(st, plan.k_steps).fields.values()))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 37, 70), (2, 6, 264), (2, 13, 5)])
def test_cuda_kernel_is_k_launches(k, dtype, shape, cuda, rng):
    """k = 4 runs as two launches of 2 stages, 9 as three of 3."""
    _, src = _pair(rng, shape, dtype)
    src = src.to(cuda)
    _build.reset_launches()
    got = ops.hdiff_kstep(src, k=k)
    assert _build.LAUNCHES["hdiff_kstep"] == len(tiling.hdiff_launches(k))
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
    other = hdiff_kstep_cuda(src, k_steps=k, tile=tiling.hdiff_kstep_tile(
        shape[1], shape[2], k, ty=4, tx=3))
    assert torch.equal(other, got)
