"""PyTorch port of the fused dycore step against the JAX package's kernels.

The same numpy inputs go through `repro.kernels.dycore_fused.ops`
(`fused_step_whole_state` and `fused_step`, Pallas in interpret mode) and
the port's counterparts on the CPU (their plain version). Tolerances are
the reference's own (`tests/test_kernels_dycore_fused.py`): the stage
tendency to 1e-5 everywhere, the diffused field to 1e-5 outside
`limiter_fragile_mask` and to 0.05 inside it; bfloat16 to 0.25. The `cuda`
cases hold the CUDA kernel against the plain version on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.dycore_fused import ops as jops
from repro.kernels.dycore_fused import ref as jref
from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels.dycore_fused import ops, ref
from repro_torch.kernels.dycore_fused.fused import fused_dycore_cuda
from repro_torch.kernels.hdiff import ref as hdiff_ref
from repro_torch.weather import convert

E, NF, GRID = 2, 4, (4, 16, 16)
LOOSE = 0.05   # |coeff * flux| scale at a flipped limiter branch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _inputs(rng, lead, dtype="float32"):
    """(f, wcon, utens, utens_stage) as jax arrays and as CPU tensors;
    `lead` are the leading axes of f (wcon drops the field axis when
    `lead` has two)."""
    wlead = lead[:1] if len(lead) == 2 else lead
    shapes = [lead, wlead, lead, lead]
    scales = [1.0, 0.15, 0.01, 0.01]
    jx = [jnp.asarray((s * rng.normal(size=sh + GRID)).astype(np.float32)
                      ).astype(dtype) for s, sh in zip(scales, shapes)]
    return jx, [convert.tensor_from_numpy(np.asarray(a), "cpu") for a in jx]


def _assert_field_close(got, want, f2, atol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    fragile = np.asarray(jref.limiter_fragile_mask(f2))
    stable = err[~fragile]
    assert stable.size == 0 or stable.max() <= atol, stable.max()
    assert err.max() <= LOOSE, err.max()


def test_whole_state_matches_pallas(rng):
    jx, tx = _inputs(rng, (E, NF))
    want_f, want_s = jops.fused_step_whole_state(*jx, ty=4, interpret=True)
    got_f, got_s = ops.fused_step_whole_state(*tx)
    assert got_f.shape == (E, NF) + GRID
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)
    f2 = jx[0] + jref.DEFAULT_DT * want_s
    _assert_field_close(got_f.numpy(), want_f, f2)


def test_per_field_matches_pallas(rng):
    jx, tx = _inputs(rng, (E,))
    want_f, want_s = jops.fused_step(*jx, ty=8, interpret=True)
    got_f, got_s = ops.fused_step(*tx)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)
    _assert_field_close(got_f.numpy(), want_f,
                        jx[0] + jref.DEFAULT_DT * want_s)


def test_whole_state_bf16_matches_pallas(rng):
    jx, tx = _inputs(rng, (E, NF), "bfloat16")
    want_f, want_s = jops.fused_step_whole_state(*jx, ty=4, interpret=True)
    got_f, got_s = ops.fused_step_whole_state(*tx)
    assert got_f.dtype == torch.bfloat16 and got_s.dtype == torch.bfloat16
    np.testing.assert_allclose(got_f.float().numpy(),
                               np.asarray(want_f, np.float32), atol=0.25)
    np.testing.assert_allclose(got_s.float().numpy(),
                               np.asarray(want_s, np.float32), atol=0.25)


def test_unfused_ref_matches_reference_oracle(rng):
    jx, tx = _inputs(rng, (E,))
    want_f, want_s = jref.fused_step_ref_batched(*jx)
    got_f, got_s = ref.fused_step_ref(*tx)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6)
    _assert_field_close(got_f.numpy(), want_f,
                        jx[0] + jref.DEFAULT_DT * want_s, atol=1e-6)


def test_summed_ref_is_the_ref_in_float32(rng):
    _, (f, wcon, t, s) = _inputs(rng, (E, NF))
    w = ops.staggered_w(wcon).unsqueeze(1)
    want_f, want_s = ref.fused_step_ref(f, wcon.unsqueeze(1), t, s)
    got_f, got_s = ref.fused_step_ref_summed(f, w, t, s)
    assert torch.equal(got_f, want_f) and torch.equal(got_s, want_s)


def test_pad_periodic_and_fragile_mask_match(rng):
    a = rng.normal(size=(2, 3, 7, 9)).astype(np.float32)
    assert np.array_equal(ref.pad_periodic(torch.from_numpy(a)).numpy(),
                          np.asarray(jref.pad_periodic(jnp.asarray(a))))
    # Quantised values make plateaus, so some points are fragile.
    a = np.round(a * 2) / 2
    want = np.asarray(jref.limiter_fragile_mask(jnp.asarray(a)))
    got = ref.limiter_fragile_mask(torch.from_numpy(a)).numpy()
    assert want.any() and np.array_equal(got, want)


def test_flip_bound_covers_fp32_noise_in_the_hdiff_input(rng):
    """Perturbing a field at fp32 noise level flips limiter branches on its
    plateaus; the hdiff output then moves by at most `limiter_flip_bound`
    (0 off the fragile mask)."""
    a = torch.from_numpy(np.round(rng.normal(size=(3, 12, 16)) * 2) / 2
                         ).float()
    moved = a + 1e-7 * torch.from_numpy(rng.normal(size=a.shape)).float()
    diff = (hdiff_ref.hdiff(ref.pad_periodic(moved))
            - hdiff_ref.hdiff(ref.pad_periodic(a)))[..., 2:-2, 2:-2]
    bound = ref.limiter_flip_bound(a)
    fragile = ref.limiter_fragile_mask(a)
    assert fragile.any() and not torch.any(bound[~fragile])
    assert (diff.abs() <= 1e-5 + bound).all()
    assert (diff.abs()[fragile] > 1e-5).any()        # some branch did flip


def test_staggered_w_sums_in_storage_dtype(rng):
    jx, tx = _inputs(rng, (E,), "bfloat16")
    want = jx[1] + jnp.roll(jx[1], -1, axis=-1)
    got = ops.staggered_w(tx[1])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.tensor_to_numpy(got),
                                  np.asarray(want).view(np.uint16))


def test_cpu_call_launches_nothing(rng):
    _, tx = _inputs(rng, (E, NF))
    before = dict(_build.LAUNCHES)
    ops.fused_step_whole_state(*tx)
    assert _build.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    _, (f, wcon, t, s) = _inputs(rng, (E, NF))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_dycore_cuda(f, ops.staggered_w(wcon), t, s)


def test_default_tile_fits_a_hopper_block():
    # several fields: 24 x 32, the tallest 32-column tile a 1024-thread
    # block holds, its field blocks in clusters of 4
    t = tiling.dycore_tile(256, 256, nf=4)
    assert (t.ty, t.tx, t.cluster) == (24, 32, 4)
    assert t.threads == 28 * 36 <= tiling.MAX_THREADS_PER_BLOCK
    assert t.smem_bytes == 2 * 4 * t.threads <= tiling.SMEM_BYTES_PER_BLOCK
    # two blocks of it within an SM's 2048 threads: the kernel's launch
    # bounds (1024 threads, 2 blocks) hold a thread to 32 registers
    assert 2 * t.threads <= 2048 and 2 * 1024 * 32 <= 65_536
    # one field: 16 x 32, clusters of one
    t = tiling.dycore_tile(256, 256)
    assert (t.ty, t.tx, t.cluster, t.threads) == (16, 32, 1, 20 * 36)
    # ty shrinks, by at most half, to the fewest computed haloed rows
    assert tiling.dycore_tile(14, 16, ty=8).ty == 7   # 2 tiles of 7 rows
    assert tiling.dycore_tile(13, 16, ty=8).ty == 7   # 14 rows, 1 idle
    assert tiling.dycore_tile(256, 256, ty=8).ty == 8
    assert tiling.dycore_tile(37, 70, nf=4).ty == 19
    assert tiling.dycore_tile(16, 16, nf=4).ty == 16


@pytest.mark.parametrize("ny", [13, 37, 64, 100, 256, 1000])
@pytest.mark.parametrize("ty", [8, 16, 24])
def test_tile_rows_compute_the_fewest_haloed_rows(ny, ty):
    got = tiling.dycore_tile(ny, 256, ty=ty).ty
    want = min(ty, ny)
    rows = lambda t: -(-ny // t) * (t + 4)
    assert want // 2 <= got <= want
    assert all(rows(got) <= rows(t) for t in range(max(1, want // 2),
                                                    want + 1))


@pytest.mark.parametrize("nz", [2, 64, 96, 1500])
@pytest.mark.parametrize("nf", [1, 4])
def test_one_build_plans_every_nz(nz, nf):
    """One build takes every nz >= 2: the sweep's scratch is in device
    memory, so the tile and its threads do not depend on the depth."""
    t = tiling.dycore_tile(256, 256, nz=nz, nf=nf)
    assert t == tiling.dycore_tile(256, 256, nf=nf)
    assert (t.op, t.tx) == ("dycore_fused", 32)
    assert (t.ty, t.threads) == ((24, 28 * 36) if nf > 1 else (16, 20 * 36))
    assert t.cluster == nf
    assert tiling.dycore_tile(37, 70, nz=nz, nf=nf).tx == 32


def test_one_level_is_refused():
    with pytest.raises(ValueError, match="nz=1"):
        tiling.dycore_tile(256, 256, nz=1)


@pytest.mark.parametrize("nf,cluster", [
    (1, 1), (2, 2), (3, 3), (4, 4), (7, 7), (8, 8), (9, 3), (10, 5),
    (11, 1), (12, 6), (16, 8)])
def test_field_blocks_cluster_by_the_largest_divisor(nf, cluster):
    """A tile's field blocks share w's coefficients in clusters of the
    largest divisor of nf up to the portable 8; more fields split into
    several clusters, each with its own copy."""
    assert tiling.dycore_cluster(nf) == cluster
    assert nf % cluster == 0 and cluster <= tiling.MAX_CLUSTER


def test_wrapper_allocates_one_coefficient_scratch_a_cluster():
    """The backward sweep's coefficient is kept once a cluster of field
    blocks, D once a block and field, nz - 1 levels of fp32 each; the C
    entry point takes both buffers and the cluster size."""
    import inspect
    import re
    from pathlib import Path

    from repro_torch.kernels.dycore_fused import fused

    tile = tiling.dycore_tile(256, 256, nz=64, nf=4)
    tiles = 11 * 8                                # 24 x 32 on 256 x 256
    ccol, dcol = fused.scratch_shapes(4, 4, 64, 256, 256, tile)
    assert ccol == (4 * tiles, 63, 1008)          # one a (member, tile)
    assert dcol == (4 * tiles * 4, 63, 1008)      # one a block
    one = tiling.dycore_tile(256, 256, 24, 32, nz=64)
    assert fused.scratch_shapes(4, 4, 64, 256, 256, one) == (dcol, dcol)
    # a state of 12 fields: two clusters of 6 a tile, a copy each
    six = tiling.dycore_tile(37, 70, 8, 32, nz=9, nf=12)
    ccol, dcol = fused.scratch_shapes(2, 12, 9, 37, 70, six)
    assert six.ty == 8 and six.cluster == 6
    assert ccol[0] * 6 == dcol[0] == 2 * 12 * 5 * 3 and ccol[1:] == (8, 432)
    src = inspect.getsource(fused.fused_dycore_cuda)
    assert "scratch_shapes(" in src and src.count("torch.empty(") == 1
    # six tensor pointers, ccol and dcol, then batch, nf and the cluster
    sig = _build._SIGNATURES["nero_dycore_fused"]
    assert sig[:11] == (_build._P,) * 8 + (_build._LL, _build._I, _build._I)
    cu = (Path(_build.CSRC) / "dycore_fused.cu").read_text()
    entry = cu[cu.index('extern "C" int nero_dycore_fused('):]
    entry = entry[entry.index("(") + 1:entry.index(")")]
    names = [re.split(r"[\s*]+", a.strip())[-1] for a in entry.split(",")]
    assert names[6:11] == ["ccol", "dcol", "batch", "nf", "cl"]
    assert len(names) == len(sig)


def test_whole_state_kernel_is_one_build():
    """One kernel and one launch path for every depth, dtype and number of
    fields: no second build and no route between builds."""
    import re
    from pathlib import Path

    cu = re.sub(r"//[^\n]*", "", (Path(_build.CSRC) / "dycore_fused.cu")
                .read_text())
    assert cu.count("__global__") == 1
    assert cu.count("cudaLaunchKernelEx(") == 1 and "<<<" not in cu
    assert "__launch_bounds__(1024, 2)" in cu
    assert not hasattr(tiling, "dycore_route")


def test_stencil_plan_tile_is_planned_at_the_grids_nz_and_fields():
    from repro_torch.weather.program import StencilProgram, compile
    for nz in (4, 96):
        plan = compile(StencilProgram(grid_shape=(nz, 16, 16), ensemble=2),
                       device="cpu")
        assert plan.tile == tiling.dycore_tile(16, 16, nz=nz, nf=4)
        assert plan.tile.cluster == 4
    # the per-field variant launches one field at a time: clusters of one
    plan = compile(StencilProgram(grid_shape=(64, 16, 16), ensemble=2,
                                  variant="per_field"), device="cpu")
    assert plan.tile.cluster == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype, cuda, rng):
    _, tx = _inputs(rng, (E, NF), dtype)
    f, wcon, t, s = (a.to(cuda) for a in tx)
    got_f, got_s = ops.fused_step_whole_state(f, wcon, t, s)
    torch.cuda.synchronize()
    # The plain version in fp32 from the same inputs and the same summed w.
    # A bf16 kernel computes in fp32 too and rounds each output once: twice
    # bf16's unit roundoff on top of the fp32 limits.
    want_f, want_s = ref.fused_step_ref_summed(
        f.float(), ops.staggered_w(wcon).float().unsqueeze(1), t.float(),
        s.float())
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    assert ((got_s.float() - want_s).abs()
            <= 1e-5 + rtol * want_s.abs()).all()
    fragile = ref.limiter_fragile_mask(f.float() + ref.DEFAULT_DT * want_s)
    excess = (got_f.float() - want_f).abs() - rtol * want_f.abs()
    assert excess[~fragile].max() <= 1e-5 and excess.max() <= LOOSE
    tile = tiling.dycore_tile(GRID[1], GRID[2], ty=4, tx=8)
    alt_f, alt_s = fused_dycore_cuda(f, ops.staggered_w(wcon), t, s,
                                     tile=tile)
    assert torch.equal(alt_f, got_f) and torch.equal(alt_s, got_s)
    one_f, one_s = ops.fused_step(f[:, 1].contiguous(), wcon,
                                  t[:, 1].contiguous(), s[:, 1].contiguous())
    assert torch.equal(one_f, got_f[:, 1]) and torch.equal(one_s, got_s[:, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("nz", [2, 9, 37, 64, 96, 1500])
@pytest.mark.parametrize("nf", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_at_any_nz(nz, nf, dtype, cuda, rng):
    """The one build on a ragged grid in clusters of nf field blocks against
    the plain version; another tiling, clusters of one and each field's
    own launch (nf = 1) bit for bit."""
    grid = (nz, 37, 70)
    shape = (2, nf) + grid
    f, wcon, t, s = (torch.from_numpy((sc * rng.normal(size=sh)).astype(
        np.float32)).to(getattr(torch, dtype)).to(cuda)
        for sc, sh in ((1.0, shape), (0.15, (2,) + grid), (0.01, shape),
                       (0.01, shape)))
    w = ops.staggered_w(wcon)
    _build.reset_launches()
    got_f, got_s = fused_dycore_cuda(f, w, t, s)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dycore_fused"] == 1
    want_f, want_s = ref.fused_step_ref_summed(
        f.float(), w.float().unsqueeze(1), t.float(), s.float())
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    assert ((got_s.float() - want_s).abs()
            <= 1e-5 + rtol * want_s.abs()).all()
    fragile = ref.limiter_fragile_mask(f.float() + ref.DEFAULT_DT * want_s)
    excess = (got_f.float() - want_f).abs() - rtol * want_f.abs()
    assert excess[~fragile].max() <= 1e-5 and excess.max() <= LOOSE
    for tile in (tiling.dycore_tile(37, 70, ty=16, tx=16, nz=nz, nf=nf),
                 tiling.dycore_tile(37, 70, nz=nz)):
        alt_f, alt_s = fused_dycore_cuda(f, w, t, s, tile=tile)
        assert torch.equal(alt_f, got_f) and torch.equal(alt_s, got_s)
    for i in range(nf):
        one_f, one_s = ops.fused_step(f[:, i].contiguous(), wcon,
                                      t[:, i].contiguous(),
                                      s[:, i].contiguous())
        assert torch.equal(one_f, got_f[:, i])
        assert torch.equal(one_s, got_s[:, i])


@pytest.mark.cuda
def test_cuda_cluster_must_divide_the_fields(cuda, rng):
    _, tx = _inputs(rng, (E, 3))
    f, wcon, t, s = (a.to(cuda) for a in tx)
    with pytest.raises(ValueError, match="does not divide nf=3"):
        fused_dycore_cuda(f, ops.staggered_w(wcon), t, s,
                          tile=tiling.dycore_tile(GRID[1], GRID[2], nf=4))
