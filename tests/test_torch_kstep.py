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


def _assert_tile_fits(t, ny, k, nz=64, ty=None):
    """The budget of one k-step cluster tile: one thread a column of
    `rows` x `tx+4k`, at most 256 threads a block, each within 255
    registers of the SM's 65,536 (one block an SM); the cluster's rows
    cover the haloed rows with at most 8 blocks; the shared memory of one
    block at `nz` levels within Hopper's 227 KB; `ty` snapped as the JAX
    package snaps its k-step window."""
    tw = t.tx + 4 * k
    assert t.op == "dycore_kstep" and t.rows >= 2
    assert t.threads == t.rows * tw <= tiling.DYCORE_KSTEP_THREADS
    assert t.threads * 255 <= 65_536           # registers: a thread's, an SM's
    assert 1 <= t.cluster <= tiling.MAX_CLUSTER
    assert t.cluster * t.rows >= t.ty + 4 * k > (t.cluster - 1) * t.rows
    assert t.smem_bytes == tiling.dycore_kstep_smem(nz, t.rows, tw) \
        == 4 * ((3 * nz | 1) * t.threads + 3 * 8 * (t.rows + 4) * tw)
    assert t.smem_bytes <= tiling.SMEM_BYTES_PER_BLOCK
    want_ty = tiling.dycore_kstep_default(k)[0] if ty is None else ty
    assert t.ty == jops.snap_ty_kstep(want_ty, ny, k)


def test_default_tile_fits_a_hopper_block():
    # The paper's domain: a 16 x 32 tile (32 x 24 from k = 3), its 2k-deep
    # halo split over a cluster of blocks; no shared-memory scratch grows
    # with the tile count.
    want = {1: (16, 32, 4, 5), 2: (16, 32, 4, 6), 3: (32, 24, 8, 6)}
    for k in (1, 2, 3):
        t = tiling.dycore_kstep_tile(256, 256, k)
        assert (t.ty, t.tx, t.cluster, t.rows) == want[k]
        _assert_tile_fits(t, 256, k)
    with pytest.raises(ValueError, match="cluster of 15 blocks"):
        tiling.dycore_kstep_tile(256, 256, 2, ty=64, tx=40)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("ny,nx,nz", [(256, 256, 64), (37, 70, 4),
                                      (37, 70, 64), (12, 16, 4),
                                      (16, 16, 4), (8, 8, 7)])
def test_kstep_tile_budget_on_the_paths_grids(k, ny, nx, nz):
    t = tiling.dycore_kstep_tile(ny, nx, k, nz=nz)
    _assert_tile_fits(t, ny, k, nz)
    if t.tx < min(tiling.dycore_kstep_default(k)[1], nx):   # narrowed:
        with pytest.raises(ValueError):        # one more column would
            tiling.dycore_kstep_tile(ny, nx, k, tx=t.tx + 1, nz=nz)  # not fit


def test_kstep_tile_narrows_to_fit_a_cluster():
    # ny = 37 is prime, so the window is all of y: 49 haloed rows at k=3
    # need 7 rows a block in 8 blocks or fewer, so the tile narrows.
    t = tiling.dycore_kstep_tile(37, 70, 3)
    assert (t.ty, t.tx, t.cluster, t.rows) == (37, 23, 7, 7)
    _assert_tile_fits(t, 37, 3)
    t = tiling.dycore_kstep_tile(37, 70, 2, ty=4, tx=16)
    assert (t.ty, t.tx) == (37, 16)            # an explicit tx is kept
    _assert_tile_fits(t, 37, 2, ty=4)


@pytest.mark.parametrize("kw,match", [
    (dict(ty=128, tx=32), "cluster of"),       # 136 haloed rows
    (dict(tx=200), "at least 2"),              # one row a block
    (dict(nz=65), "nz=65"),                    # past the register arrays
    (dict(nz=1), "nz=1"),
])
def test_kstep_tile_that_does_not_fit_is_refused(kw, match):
    with pytest.raises(ValueError, match=match):
        tiling.dycore_kstep_tile(256, 256, 2, **kw)


@pytest.mark.parametrize("nz", [2, 3, 7, 9, 37, 64])
def test_kstep_takes_every_nz_up_to_its_register_arrays(nz):
    # One build, 64-level register arrays: every nz in [2, 64] runs it, and
    # the tile's shared memory is planned at the column's own nz.
    tiling.check_kstep_nz(nz)
    t = tiling.dycore_kstep_tile(256, 256, 2, nz=nz)
    _assert_tile_fits(t, 256, 2, nz)
    assert nz <= tiling.DYCORE_KSTEP_MAX_NZ == 64


def test_kstep_plan_tile_is_planned_at_the_grids_nz():
    from repro_torch.weather.program import StencilProgram, compile
    plan = compile(StencilProgram(grid_shape=(4, 16, 16), ensemble=2,
                                  variant="kstep", k_steps=2), device="cpu")
    assert plan.tile == tiling.dycore_kstep_tile(16, 16, 2, nz=4)
    assert plan.tile.smem_bytes == tiling.dycore_kstep_smem(
        4, plan.tile.rows, plan.tile.tx + 8)


def test_kernel_wrapper_refuses_what_no_build_takes(rng):
    shape = (2, 65, 8, 8)                      # nz = 65
    f = torch.zeros(shape)
    w = torch.zeros(shape[1:])
    with pytest.raises(ValueError, match="nz=65"):
        fused_dycore_kstep_cuda(f, w, f, f, k_steps=2)
    _, (f, wcon, t, s) = _inputs(rng, SHAPE)
    k3 = tiling.dycore_kstep_tile(12, 16, 3)
    with pytest.raises(ValueError, match="not planned for k_steps=2"):
        fused_dycore_kstep_cuda(f, ops.staggered_w(wcon), t, s, k_steps=2,
                                tile=k3)


def test_both_dycore_kernels_share_one_column_routine():
    """The Thomas arithmetic exists once, in `csrc/dycore_column.cuh`: the
    whole-state and k-step kernels call its coefficient and chunk routines
    and hold no divisions or coefficient products of their own."""
    import re
    from pathlib import Path

    csrc = Path(_build.CSRC)
    column = (csrc / "dycore_column.cuh").read_text()
    assert "thomas_forward" not in column and "thomas_back_level" not in column
    for fn in ("w_level", "w_record", "forward_chunk", "backward_chunk",
               "c_coef"):
        assert f" {fn}(" in column
    for name in ("dycore_fused.cu", "dycore_kstep.cu"):
        src = (csrc / name).read_text()
        code = re.sub(r"//[^\n]*", "", src)          # comments out
        assert '#include "dycore_column.cuh"' in code
        for fn in ("forward_chunk", "backward_chunk"):
            assert f"nero::{fn}<" in code, (name, fn)
        assert "nero::w_record<" in code or "nero::w_level(" in code, name
        assert "1.0f /" not in code and "kBet" not in code, name
        assert "thomas_" not in code


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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("nz", [2, 3, 7, 9, 37, 64])
def test_cuda_kernel_is_k_whole_state_launches_at_odd_nz(k, nz, cuda, rng):
    shape = (2, 3, nz, 37, 70)                 # batch 2, ragged tiles
    _, tx = _inputs(rng, shape)
    f, wcon, t, s = (a.to(cuda) for a in tx)
    w = ops.staggered_w(wcon)
    _build.reset_launches()
    got_f, got_s = fused_dycore_kstep_cuda(f, w, t, s, k_steps=k)
    assert _build.LAUNCHES["dycore_kstep"] == 1
    for _ in range(k):
        f, s = fused_dycore_cuda(f, w, t, s)
    torch.cuda.synchronize()
    assert torch.equal(got_f, f) and torch.equal(got_s, s)
    tile = tiling.dycore_kstep_tile(37, 70, k, ty=4, tx=16, nz=nz)
    alt_f, alt_s = fused_dycore_kstep_cuda(tx[0].to(cuda), w, t,
                                           tx[3].to(cuda), k_steps=k,
                                           tile=tile)
    assert torch.equal(alt_f, got_f) and torch.equal(alt_s, got_s)


@pytest.mark.cuda
@pytest.mark.parametrize("nz", [3, 37, 64])
def test_cuda_bf16_kernel_rounds_once_at_any_nz(nz, cuda, rng):
    _, tx = _inputs(rng, (2, 2, nz, 20, 36), "bfloat16")
    f, wcon, t, s = (a.to(cuda) for a in tx)
    w = ops.staggered_w(wcon)
    got_f, got_s = fused_dycore_kstep_cuda(f, w, t, s, k_steps=3)
    up_f, up_s = fused_dycore_kstep_cuda(f.float(), w.float(), t.float(),
                                         s.float(), k_steps=3)
    torch.cuda.synchronize()
    assert torch.equal(got_f, up_f.bfloat16())
    assert torch.equal(got_s, up_s.bfloat16())
