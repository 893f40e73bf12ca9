"""PyTorch port of the k-step dycore round against the JAX package's kernel.

The same numpy inputs go through `repro.kernels.dycore_fused.ops.
fused_step_kstep` (Pallas in interpret mode) and the port's
`ops.fused_step_kstep` on the CPU (its plain version, `ref.fused_kstep_ref`).
Tolerances are the reference's own for a k-step round against k sequential
steps (`tests/test_kernels_dycore_fused.py`): at most 2 points over 1e-5
and every point within 0.05 (a limiter branch may flip across the chain);
bfloat16 within 0.5. The `cuda` cases hold the CUDA kernel against k
whole-state launches on the card, bit for bit in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.dycore_fused import ops as jops
from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels.dycore_fused import ops, ref
from repro_torch.kernels.dycore_fused.fused import fused_dycore_cuda
from repro_torch.kernels.dycore_fused.kstep import fused_dycore_kstep_cuda
from repro_torch.weather import convert

SHAPE = (3, 4, 12, 16)   # (nf, nz, ny, nx), the reference's k-step shape
LOOSE = 0.05             # |coeff * flux| scale at a flipped limiter branch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _inputs(rng, shape, dtype="float32"):
    """(fs, wcon, utens, utens_stage) as jax arrays and as CPU tensors,
    scaled as the reference's `_whole_inputs`; wcon drops the field axis."""
    wshape = shape[:-4] + shape[-3:]
    jx = [jnp.asarray((s * rng.normal(size=sh)).astype(np.float32)
                      ).astype(dtype)
          for s, sh in ((1.0, shape), (0.15, wshape), (0.01, shape),
                        (0.01, shape))]
    return jx, [convert.tensor_from_numpy(np.asarray(a), "cpu") for a in jx]


def _assert_kstep_close(got, want, most_over=2):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    bad = int((err > 1e-5).sum())
    assert bad <= most_over and err.max() < LOOSE, (bad, err.max())


@pytest.mark.parametrize("k", [2, 3])
def test_kstep_matches_pallas(k, rng):
    jx, tx = _inputs(rng, SHAPE)
    want_f, want_s = jops.fused_step_kstep(*jx, k_steps=k, ty=2 * k,
                                           interpret=True)
    got_f, got_s = ops.fused_step_kstep(*tx, k_steps=k)
    assert got_f.shape == SHAPE and got_s.shape == SHAPE
    _assert_kstep_close(got_f.numpy(), want_f)
    _assert_kstep_close(got_s.numpy(), want_s)


def test_batched_kstep_matches_pallas(rng):
    shape = (2,) + SHAPE[:2] + (16, 16)        # (E, nf, nz, ny, nx)
    jx, tx = _inputs(rng, shape)
    want_f, want_s = jops.fused_step_kstep(*jx, k_steps=2, ty=4,
                                           interpret=True)
    got_f, got_s = ops.fused_step_kstep(*tx, k_steps=2)
    _assert_kstep_close(got_f.numpy(), want_f)
    _assert_kstep_close(got_s.numpy(), want_s)


def test_kstep_bf16_matches_pallas(rng):
    jx, tx = _inputs(rng, SHAPE, "bfloat16")
    want_f, want_s = jops.fused_step_kstep(*jx, k_steps=2, ty=4,
                                           interpret=True)
    got_f, got_s = ops.fused_step_kstep(*tx, k_steps=2)
    assert got_f.dtype == torch.bfloat16 and got_s.dtype == torch.bfloat16
    for got, want in ((got_f, want_f), (got_s, want_s)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=0.5)


def test_k1_is_the_whole_state_step(rng):
    _, tx = _inputs(rng, SHAPE)
    want_f, want_s = ops.fused_step_whole_state(*tx)
    got_f, got_s = ops.fused_step_kstep(*tx, k_steps=1)
    assert torch.equal(got_f, want_f) and torch.equal(got_s, want_s)


@pytest.mark.parametrize("k", [2, 3])
def test_plain_kstep_is_k_plain_steps_in_fp32(k, rng):
    _, (f, wcon, t, s) = _inputs(rng, SHAPE)
    got_f, got_s = ref.fused_kstep_ref(f, ops.staggered_w(wcon), t, s, k)
    for _ in range(k):
        f, s = ops.fused_step_whole_state(f, wcon, t, s)
    assert torch.equal(got_f, f) and torch.equal(got_s, s)


def test_plain_kstep_rounds_bf16_once(rng):
    _, tx = _inputs(rng, SHAPE, "bfloat16")
    got_f, got_s = ops.fused_step_kstep(*tx, k_steps=2)
    f, wcon, t, s = (a.float() for a in tx)
    w = ops.staggered_w(tx[1]).float()          # summed in bf16, as the kernel
    want_f, want_s = ref.fused_kstep_ref(f, w, t, s, 2)
    assert torch.equal(got_f, want_f.bfloat16())
    assert torch.equal(got_s, want_s.bfloat16())


@pytest.mark.parametrize("ny,k", [(3, 2), (5, 3), (8, 5)])
def test_ny_below_2k_is_refused(ny, k):
    with pytest.raises(ValueError, match="k_steps"):
        jops.snap_ty_kstep(8, ny, k)
    with pytest.raises(ValueError, match="k_steps"):
        tiling.snap_ty_kstep(8, ny, k)
    with pytest.raises(ValueError, match="k_steps"):
        tiling.dycore_kstep_tile(ny, 16, k)


@pytest.mark.parametrize("ty,ny,k", [(8, 256, 2), (8, 256, 3), (4, 12, 3),
                                     (0, 16, 2), (7, 14, 2), (8, 9, 2)])
def test_snap_ty_kstep_matches_the_reference(ty, ny, k):
    assert tiling.snap_ty_kstep(ty, ny, k) == jops.snap_ty_kstep(ty, ny, k)


def test_cpu_call_launches_nothing(rng):
    _, tx = _inputs(rng, SHAPE)
    before = dict(_build.LAUNCHES)
    ops.fused_step_kstep(*tx, k_steps=2)
    assert _build.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    _, (f, wcon, t, s) = _inputs(rng, SHAPE)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_dycore_kstep_cuda(f, ops.staggered_w(wcon), t, s, k_steps=2)


def test_default_tile_fits_a_hopper_block():
    for k in (1, 2, 3):
        t = tiling.dycore_kstep_tile(256, 256, k)
        assert (t.ty, t.tx) == (8, 32)
        assert t.threads <= tiling.KSTEP_THREADS <= tiling.MAX_THREADS_PER_BLOCK
        assert t.smem_bytes == 3 * 4 * (8 + 4 * k) * (32 + 4 * k)
        assert t.smem_bytes <= tiling.SMEM_BYTES_PER_BLOCK
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tiling.dycore_kstep_tile(256, 256, 2, ty=128, tx=256)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3])
def test_cuda_kernel_is_k_whole_state_launches(k, cuda, rng):
    shape = (2,) + SHAPE[:2] + (37, 70)        # ragged tiles
    _, tx = _inputs(rng, shape)
    f, wcon, t, s = (a.to(cuda) for a in tx)
    w = ops.staggered_w(wcon)
    _build.reset_launches()
    got_f, got_s = ops.fused_step_kstep(f, wcon, t, s, k_steps=k)
    assert _build.LAUNCHES["dycore_kstep"] == 1
    for _ in range(k):
        f, s = fused_dycore_cuda(f, w, t, s)
    torch.cuda.synchronize()
    assert torch.equal(got_f, f) and torch.equal(got_s, s)
    tile = tiling.dycore_kstep_tile(37, 70, k, ty=4, tx=16)
    alt_f, alt_s = fused_dycore_kstep_cuda(tx[0].to(cuda), w, t,
                                           tx[3].to(cuda), k_steps=k,
                                           tile=tile)
    assert torch.equal(alt_f, got_f) and torch.equal(alt_s, got_s)


@pytest.mark.cuda
def test_cuda_bf16_kernel_rounds_once(cuda, rng):
    _, tx = _inputs(rng, SHAPE, "bfloat16")
    f, wcon, t, s = (a.to(cuda) for a in tx)
    w = ops.staggered_w(wcon)
    got_f, got_s = fused_dycore_kstep_cuda(f, w, t, s, k_steps=2)
    up_f, up_s = fused_dycore_kstep_cuda(f.float(), w.float(), t.float(),
                                         s.float(), k_steps=2)
    torch.cuda.synchronize()
    assert torch.equal(got_f, up_f.bfloat16())
    assert torch.equal(got_s, up_s.bfloat16())
