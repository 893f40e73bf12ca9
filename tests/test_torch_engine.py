"""The port's NeroEngine against the JAX package's.

Mirrors `tests/test_engine.py`: plan caching, the precision-dependent
Pareto pick, and dispatch. The same numpy inputs go through the JAX engine
(Pallas in interpret mode on the CPU) and the port's `NeroEngine(device=
"cpu")` (the kernels' plain versions): hdiff within 1e-5, vadvc within
2e-4 (the JAX package's own kernel tolerances), copy exactly. Under the
same hierarchy and spec both engines plan the same window. Every window the
planner can pick under `h100_sxm` maps to a legal CUDA tile. The `cuda`
cases hold a CUDA engine's result against a direct kernel call bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core import hierarchy as jhw
from repro.core import hwspec as jhwspec
from repro.core import tiling as jtiling
from repro.core.autotune import tune as jtune
from repro.core.engine import NeroEngine as JEngine
from repro_torch.core import hierarchy as hw
from repro_torch.core import hwspec, tiling
from repro_torch.core.autotune import tune
from repro_torch.core.engine import NeroEngine
from repro_torch.kernels import _build
from repro_torch.kernels.hdiff import ref as href
from repro_torch.kernels.vadvc import ref as vref

CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _t(a, device=CPU):
    return torch.from_numpy(np.asarray(a)).to(device)


def test_plan_is_cached_and_fits():
    eng = NeroEngine(device="cpu")
    t1 = eng.plan("hdiff", (8, 64, 64), torch.float32)
    t2 = eng.plan("hdiff", (8, 64, 64), "float32")
    assert t1 is t2
    assert t1.plan.fits(eng.hier)
    assert eng.hier == hw.h100_sxm()
    assert t1.est.time_s > 0 and t1.est.hardware == "h100_sxm"
    assert eng.estimate("hdiff", (8, 64, 64), "float32") is t1.est
    t3 = eng.plan("hdiff", (8, 64, 64), "float32", measure=lambda p: 1.0)
    assert t3 is not t1 and eng.plan("hdiff", (8, 64, 64), "float32") is t3


def test_precision_changes_pareto_choice():
    eng = NeroEngine(device="cpu")
    p32 = eng.plan("hdiff", (64, 256, 256), torch.float32).plan
    p16 = eng.plan("hdiff", (64, 256, 256), torch.bfloat16).plan
    # paper Fig. 6: the chosen window depends on dtype (bf16 fits more);
    # on the H100's 227 KB of shared memory it binds
    assert p16.vmem_bytes <= p32.vmem_bytes * 2
    assert p16.tile != p32.tile
    assert p16.tile_points > p32.tile_points


@pytest.mark.parametrize("op,grid", [("hdiff", (8, 64, 64)),
                                     ("hdiff", (64, 256, 256)),
                                     ("vadvc", (64, 256, 256)),
                                     ("copy", (64, 256, 256))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engines_plan_the_same_window(op, grid, dtype, monkeypatch):
    monkeypatch.setenv("REPRO_HWSPEC", "tpu_v5e")
    want = JEngine().plan(op, grid, jnp.dtype(dtype))
    got = NeroEngine(hier=hw.tpu_v5e(), device="cpu").plan(op, grid, dtype)
    assert got.plan.tile == want.plan.tile
    assert got.est.time_s == pytest.approx(want.est.time_s, rel=1e-12)
    assert [m for _, m in got.pareto] == [m for _, m in want.pareto]
    assert [t for t, _ in got.pareto] == pytest.approx(
        [t for t, _ in want.pareto], rel=1e-12)


def test_run_hdiff_matches_the_jax_engine():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(4, 16, 128)).astype(np.float32)
    jeng, eng = JEngine(), NeroEngine(device="cpu")
    want = jeng.run(jeng.plan("hdiff", src.shape, jnp.float32),
                    jnp.asarray(src))
    got = eng.run(eng.plan("hdiff", src.shape, "float32"), _t(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), href.hdiff(_t(src)).numpy(),
                               atol=1e-5)


def test_run_vadvc_matches_the_jax_engine():
    rng = np.random.default_rng(1)
    shp = (8, 8, 128)
    f = lambda: rng.normal(size=shp).astype(np.float32)
    wcon = rng.normal(size=(8, 8, 129)).astype(np.float32)
    u, up, ut, us = f(), f(), f(), f()
    jeng, eng = JEngine(), NeroEngine(device="cpu")
    want = jeng.run(jeng.plan("vadvc", shp, jnp.float32),
                    *(jnp.asarray(a) for a in (u, wcon, up, ut, us)))
    got = eng.run(eng.plan("vadvc", shp, "float32"),
                  *(_t(a) for a in (u, wcon, up, ut, us)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(
        got.numpy(), vref.vadvc(*(_t(a) for a in (u, wcon, up, ut, us)))
        .numpy(), atol=2e-4, rtol=2e-4)


def test_run_copy_matches_the_jax_engine():
    rng = np.random.default_rng(2)
    src = rng.normal(size=(512, 128)).astype(np.float32)
    jeng, eng = JEngine(), NeroEngine(device="cpu")
    want = jeng.run(jeng.plan("copy", (1, 512, 128), jnp.float32),
                    jnp.asarray(src))
    got = eng.run(eng.plan("copy", (1, 512, 128), "float32"), _t(src))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="tr=256"):
        eng.run(eng.plan("copy", (1, 500, 128), "float32"),
                _t(src[:500]))


def test_precision_dependent_pareto_under_bram_budget():
    """Paper Fig. 6, as the JAX package asserts it: the Pareto-optimal
    window depends on precision when near memory binds (1 MiB, an FPGA
    PE's BRAM), and not at the TPU's 64 MiB VMEM budget."""
    hier = hw.tpu_v5e()
    small = hw.Hierarchy(
        hbm=hier.hbm,
        vmem=hw.MemoryLevel("vmem", 2**20, hier.vmem.bandwidth_bytes_per_s,
                            hier.vmem.energy_pj_per_byte),
        vreg=hier.vreg, peak_flops_bf16=hier.peak_flops_bf16,
        peak_flops_fp32=hier.peak_flops_fp32, ici_bw=hier.ici_bw)
    jsmall = jhw.Hierarchy(
        hbm=jhw.tpu_v5e().hbm,
        vmem=jhw.MemoryLevel("vmem", 2**20, hier.vmem.bandwidth_bytes_per_s,
                             hier.vmem.energy_pj_per_byte),
        vreg=jhw.tpu_v5e().vreg)
    grid = (64, 256, 256)
    jspec, spec = jhwspec.load_spec("tpu_v5e"), hwspec.load_spec("tpu_v5e")
    for op, jop in ((tiling.VADVC, jtiling.VADVC),
                    (tiling.HDIFF, jtiling.HDIFF)):
        c32 = tune(op, grid, "float32", small, spec=spec).plan
        c16 = tune(op, grid, "bfloat16", small, spec=spec).plan
        assert c32.tile != c16.tile, op.name
        assert c16.tile_points > c32.tile_points, op.name
        assert c32.tile == jtune(jop, grid, "float32", jsmall,
                                 spec=jspec).plan.tile
        assert c16.tile == jtune(jop, grid, "bfloat16", jsmall,
                                 spec=jspec).plan.tile
        v32 = tune(op, grid, "float32", hier, spec=spec).plan
        v16 = tune(op, grid, "bfloat16", hier, spec=spec).plan
        assert v32.tile == v16.tile, op.name


def test_cpu_operands_to_a_cuda_engine_raise():
    eng = NeroEngine()                    # the card, the default
    assert eng.device.type == "cuda"
    src = torch.zeros(4, 16, 128)
    tuned = eng.plan("hdiff", tuple(src.shape), "float32")
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="engine runs on cuda"):
        eng.run(tuned, src)
    with pytest.raises(ValueError, match="operand 0"):
        eng.run(eng.plan("copy", (1, 256, 8), "float32"),
                torch.zeros(256, 8))
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="expected 'cuda' or 'cpu'"):
        NeroEngine(device="meta")


def test_unported_op_raises():
    eng = NeroEngine(device="cpu")
    with pytest.raises(NotImplementedError):
        eng.run(eng.plan("lru_scan", (64, 8, 1), "float32"),
                torch.zeros(64, 8))


@pytest.mark.parametrize("op", ["hdiff", "vadvc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid", [(8, 64, 64), (64, 256, 256),
                                  (64, 260, 260)])
def test_every_h100_candidate_maps_to_a_legal_cuda_tile(op, dtype, grid):
    h100 = hw.h100_sxm()
    cands = tiling.candidate_tiles(tiling.HDIFF if op == "hdiff"
                                   else tiling.VADVC, grid, dtype, h100)
    assert cands
    for plan in cands:
        tile = tiling.cuda_tile_for(plan)       # CudaTile checks its limits
        assert tile.op == op
        assert 1 <= tile.ty <= min(plan.tile[1], grid[1])
        assert 1 <= tile.tx <= min(plan.tile[2], grid[2])
        assert tile.threads <= tiling.MAX_THREADS_PER_BLOCK
        assert tile.smem_bytes <= tiling.SMEM_BYTES_PER_BLOCK
    picked = NeroEngine(device="cpu").plan(op, grid, dtype).plan
    assert tiling.cuda_tile_for(picked).threads <= 1024


def test_cuda_tile_clamps_a_wide_window():
    # hdiff streams a window's x extent as its strip and y extent as its
    # segment: 64 x 128 on 256 x 256 is 4 segments of 64 rows and 2 strips
    # of 128 columns, a thread for each 2 columns of a strip, its halo and
    # 1 column of slack (133, so 3 warps); a window wider than 1024 threads
    # hold is clamped to 2043 columns, then balanced (8192 columns: 5
    # strips of 1639). A vadvc warp takes a row segment of at most 32 of
    # the window's columns, one a lane, and at most what fits nz levels.
    plan = tiling.TilePlan(op=tiling.HDIFF, grid_shape=(64, 256, 256),
                           tile=(1, 64, 128), dtype="float32")
    tile = tiling.cuda_tile_for(plan)
    assert (tile.ty, tile.tx, tile.threads) == (64, 128, 96)
    wide = tiling.cuda_tile_for(tiling.TilePlan(
        op=tiling.HDIFF, grid_shape=(1, 64, 8192), tile=(1, 64, 8192),
        dtype="float32"))
    assert (wide.ty, wide.tx, wide.threads) == (64, 1639, 832)
    widest = tiling.cuda_tile_for(tiling.TilePlan(
        op=tiling.HDIFF, grid_shape=(1, 64, 2043), tile=(1, 64, 2048),
        dtype="float32"))
    assert (widest.tx, widest.threads) == (2043, 1024)
    plan = tiling.TilePlan(op=tiling.VADVC, grid_shape=(64, 256, 256),
                           tile=(64, 64, 128), dtype="float32")
    tile = tiling.cuda_tile_for(plan)
    assert (tile.ty, tile.tx, tile.threads) == (1, 32, 32)
    narrow = tiling.cuda_tile_for(tiling.TilePlan(
        op=tiling.VADVC, grid_shape=(1500, 256, 256), tile=(1500, 8, 16),
        dtype="bfloat16"))
    assert (narrow.ty, narrow.tx, narrow.threads) == (1, 15, 32)  # fits
    with pytest.raises(ValueError, match="no CUDA tile"):
        tiling.cuda_tile_for(tiling.TilePlan(
            op=tiling.COPY, grid_shape=(1, 8, 8), tile=(1, 1, 1),
            dtype="float32"))


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_engine_equals_direct_kernel_calls(dtype, cuda):
    from repro_torch.kernels.copy_stencil.copy_stencil import copy_cuda
    from repro_torch.kernels.hdiff.hdiff import hdiff_cuda
    from repro_torch.kernels.vadvc.vadvc import vadvc_cuda

    gen = torch.Generator(device=cuda).manual_seed(0)
    shp = (8, 64, 96)
    f = lambda *s: torch.randn(s or shp, generator=gen, device=cuda).to(dtype)
    eng = NeroEngine()
    src = f()
    _build.reset_launches()
    got = eng.run(eng.plan("hdiff", shp, dtype), src)
    assert torch.equal(got, hdiff_cuda(src))
    fields = (f(), 0.15 * f(8, 64, 97), f(), f(), f())
    got = eng.run(eng.plan("vadvc", shp, dtype), *fields)
    assert torch.equal(got, vadvc_cuda(*fields))
    flat = src.reshape(-1, shp[-1])[:256]
    got = eng.run(eng.plan("copy", (1, 256, 96), dtype), flat)
    assert torch.equal(got, copy_cuda(flat))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["hdiff"] == 2 and _build.LAUNCHES["vadvc"] == 2
    assert _build.LAUNCHES["copy"] == 2


def test_run_hdiff_takes_a_coefficient_as_the_jax_engine_does():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(2, 12, 16)).astype(np.float32)
    jeng, eng = JEngine(), NeroEngine(device="cpu")
    want = jeng.run(jeng.plan("hdiff", src.shape, jnp.float32),
                    jnp.asarray(src), 0.1)
    got = eng.run(eng.plan("hdiff", src.shape, "float32"), _t(src), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not np.allclose(got.numpy(), href.hdiff(_t(src)).numpy(),
                           atol=1e-5)
