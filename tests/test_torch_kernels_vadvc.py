"""PyTorch port of vadvc against the JAX package's kernel and oracles.

The same numpy inputs go through `repro.kernels.vadvc.vadvc.vadvc_pallas`
(interpret mode), the numpy oracle `vadvc_np` and the port's `ops.vadvc` on
the CPU (its plain version), at the reference's tolerance of 2e-4
(`tests/test_kernels_vadvc.py`). A periodic wcon `(..., nz, ny, nx)`, whose
column nx is column 0, gives the bits of the staggered one built by
appending column 0. The `cuda` cases hold the CUDA kernel against the plain
version on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.vadvc import ref as jref
from repro.kernels.vadvc.vadvc import vadvc_pallas
from repro_torch.core import tiling
from repro_torch.kernels import _build
from repro_torch.kernels.vadvc import ops, ref
from repro_torch.kernels.vadvc.vadvc import vadvc_cuda

SHAPES_TILES = [((4, 4, 8), (2, 4)), ((8, 8, 16), (4, 8)),
                ((16, 2, 8), (2, 8)), ((64, 4, 8), (2, 4))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _fields(rng, nz, ny, nx, scale=0.2):
    """(u_stage, wcon, u_pos, utens, utens_stage) as numpy float32."""
    us, up, ut, uts = (rng.normal(size=(nz, ny, nx)).astype(np.float32)
                       for _ in range(4))
    wcon = rng.uniform(-scale, scale, size=(nz, ny, nx + 1)).astype(
        np.float32)
    return us, wcon, up, ut, uts


@pytest.mark.parametrize("shape,tiles", SHAPES_TILES)
def test_plain_vadvc_matches_pallas_and_numpy(shape, tiles, rng):
    args = _fields(rng, *shape)
    tj, ti = tiles
    pallas = np.asarray(vadvc_pallas(*map(jnp.asarray, args), tj=tj, ti=ti,
                                     interpret=True))
    oracle = jref.vadvc_np(*args)
    got = ops.vadvc(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


def test_plain_vadvc_matches_jnp_oracle_bf16(rng):
    args = [jnp.asarray(a).astype(jnp.bfloat16)
            for a in _fields(rng, 8, 4, 8)]
    want = np.asarray(jref.vadvc(*args), np.float32)
    got = ref.vadvc(*(torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in args))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-4)


def test_constants_match_the_reference():
    assert (ref.DTR_STAGE, ref.BET_M, ref.BET_P) == (
        jref.DTR_STAGE, jref.BET_M, jref.BET_P)


def test_solution_satisfies_the_system(rng):
    args = _fields(rng, 8, 4, 8)
    out = ref.vadvc(*map(torch.from_numpy, args)).double().numpy()
    assert jref.tridiagonal_residual(*args, out) < 1e-4


def test_leading_axes_are_independent_columns(rng):
    per = [_fields(rng, 6, 3, 4) for _ in range(2)]
    batched = [torch.from_numpy(np.stack(a)) for a in zip(*per)]
    out = ref.vadvc(*batched)
    for e in range(2):
        want = ref.vadvc(*map(torch.from_numpy, per[e]))
        assert torch.equal(out[e], want)


def test_member_wcon_is_shared_by_its_fields(rng):
    """`ops.vadvc` with wcon `(E, ...)` under fields `(E, nf, ...)` is each
    field's own solve with its member's wcon, bit for bit."""
    E, NF = 2, 3
    us = torch.from_numpy(rng.normal(size=(E, NF, 6, 3, 5)).astype(
        np.float32))
    ut, uts = (torch.from_numpy(rng.normal(size=us.shape).astype(np.float32))
               for _ in range(2))
    wcon = torch.from_numpy(rng.uniform(-0.2, 0.2, size=(E, 6, 3, 6)).astype(
        np.float32))
    out = ops.vadvc(us, wcon, us, ut, uts)
    for e in range(E):
        for f in range(NF):
            want = ref.vadvc(us[e, f], wcon[e], us[e, f], ut[e, f], uts[e, f])
            assert torch.equal(out[e, f], want)


def test_cpu_call_launches_nothing(rng):
    before = dict(_build.LAUNCHES)
    ops.vadvc(*map(torch.from_numpy, _fields(rng, 4, 4, 8)))
    assert _build.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    with pytest.raises(ValueError, match="CUDA tensor"):
        vadvc_cuda(*map(torch.from_numpy, _fields(rng, 4, 4, 8)))


def test_kernel_wrapper_refuses_wcon_not_led_like_the_fields(rng):
    us, wcon, up, ut, uts = (torch.from_numpy(a).expand((2, 3) + a.shape)
                             for a in _fields(rng, 4, 4, 8))
    with pytest.raises(ValueError, match="prefix"):
        vadvc_cuda(us, wcon[0], up, ut, uts)     # wcon (3, ...): not (2,)


def _periodic(wcon):
    """The periodic wcon whose staggered form is `wcon` with its last
    column replaced by its first."""
    return wcon[..., :-1].contiguous()


@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
def test_periodic_wcon_equals_the_staggered_cat(lead, rng):
    """`ops.vadvc` given a periodic wcon equals `ops.vadvc` given the
    staggered wcon that appends column 0, bit for bit (on the CPU: the
    plain version); a member's wcon shared by its fields either way."""
    nz, ny, nx = 7, 5, 9
    us, ut, uts = (torch.from_numpy(rng.normal(size=lead + (nz, ny, nx))
                                    .astype(np.float32)) for _ in range(3))
    wp = torch.from_numpy(rng.uniform(-0.2, 0.2, size=lead[:1] + (nz, ny, nx))
                          .astype(np.float32))
    ws = torch.cat([wp, wp[..., :1]], dim=-1)
    for dtype in (torch.float32, torch.bfloat16):
        a = [t.to(dtype) for t in (us, wp, us, ut, uts)]
        b = [t.to(dtype) for t in (us, ws, us, ut, uts)]
        assert torch.equal(ops.vadvc(*a), ops.vadvc(*b))
    with pytest.raises(ValueError, match="wide"):
        ref.vadvc(us, ws[..., :-2], us, ut, uts)


@pytest.mark.parametrize("nz,itemsize,cols", [
    (64, 4, 32), (64, 2, 32), (2, 4, 32), (1500, 4, 12), (1500, 2, 15)])
def test_tile_takes_fewer_columns_for_tall_columns(nz, itemsize, cols):
    """A warp a block: 32 columns, one a lane, while nz levels of (c, d)
    and u_pos fit a block's shared memory with the ring; fewer above."""
    t = tiling.vadvc_tile(256, 256, nz, itemsize)
    assert (t.ty, t.threads) == (1, 32)
    assert t.smem_bytes <= tiling.SMEM_BYTES_PER_BLOCK
    assert t.tx == tiling.balanced(256, cols)
    assert tiling.vadvc_smem(nz, cols + 1, itemsize) > \
        tiling.SMEM_BYTES_PER_BLOCK or cols == tiling.VADVC_COLS
    assert tiling.vadvc_tile(37, 70, 64).tx == 24       # 3 balanced segments
    with pytest.raises(ValueError, match="columns a warp"):
        tiling.vadvc_tile(37, 70, 64, cols=33)


def test_one_kernel_and_no_device_scratch():
    """`csrc/vadvc.cu` holds one kernel for every nz, dtype and wcon form,
    launched from one place; the sweep's (c, d) live in shared memory, so
    neither the C entry nor the wrapper has a scratch buffer, and the
    wrapper allocates only the output."""
    import inspect

    from repro_torch.kernels.vadvc import vadvc as wrapper

    code = re.sub(r"//[^\n]*", "",
                  (Path(_build.CSRC) / "vadvc.cu").read_text())
    assert code.count("__global__") == 1 and code.count("<<<") == 1
    assert "cp_async4(" in code and "cp.async.ca.shared.global" in code
    entry = code[code.index('extern "C" int nero_vadvc('):]
    entry = entry[entry.index("(") + 1:entry.index(")")]
    names = [re.split(r"[\s*]+", a.strip())[-1] for a in entry.split(",")]
    assert names[:7] == ["ustage", "wcon", "upos", "utens", "ustagetens",
                         "out", "batch"]
    assert "wcon_w" in names and "ccol" not in names and "dcol" not in names
    assert len(names) == len(_build._SIGNATURES["nero_vadvc"])
    src = inspect.getsource(wrapper.vadvc_cuda)
    assert src.count("torch.empty") == 1 and "empty_like(u_stage)" in src


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(dtype, cuda, rng):
    args = [torch.from_numpy(a).to(cuda, dtype)
            for a in _fields(rng, 64, 37, 70)]
    got = ops.vadvc(*args)
    torch.cuda.synchronize()
    # The plain version in fp32 from the same inputs. A bf16 kernel computes
    # in fp32 too and rounds its output once: twice bf16's unit roundoff.
    want = ref.vadvc(*(a.float() for a in args))
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    assert ((got.float() - want).abs() <= 2e-4 + rtol * want.abs()).all()
    other = vadvc_cuda(*args, tile=tiling.vadvc_tile(37, 70, 64, cols=16))
    assert torch.equal(other, got)


@pytest.mark.cuda
@pytest.mark.parametrize("nz", [2, 3, 64, 1500])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_at_every_depth(nz, dtype, cuda, rng):
    """nz 2 to 1500 (fewer columns a warp) on a ragged (37, 70) plane,
    against the plain version; two block geometries bit for bit; a
    periodic wcon bit for bit with the staggered one that appends its
    column 0; u_pos apart from u_stage."""
    us, wcon, up, ut, uts = (torch.from_numpy(a).to(cuda, dtype)
                             for a in _fields(rng, nz, 37, 70))
    wcon[..., -1] = wcon[..., 0]
    got = vadvc_cuda(us, wcon, up, ut, uts)
    torch.cuda.synchronize()
    want = ref.vadvc(*(a.float() for a in (us, wcon, up, ut, uts)))
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    assert ((got.float() - want).abs() <= 2e-4 + rtol * want.abs()).all()
    isz = us.element_size()
    narrow = tiling.vadvc_tile(37, 70, nz, isz, cols=7)
    assert narrow.tx != tiling.vadvc_tile(37, 70, nz, isz).tx
    assert torch.equal(vadvc_cuda(us, wcon, up, ut, uts, tile=narrow), got)
    assert torch.equal(vadvc_cuda(us, _periodic(wcon), up, ut, uts), got)
    same = vadvc_cuda(us, wcon, us, ut, uts)       # u_pos is u_stage
    assert torch.equal(same, vadvc_cuda(us, wcon, us.clone(), ut, uts))


@pytest.mark.cuda
def test_cuda_kernel_shares_member_wcon(cuda, rng):
    per = [_fields(rng, 16, 9, 33) for _ in range(6)]       # (E=2) x (nf=3)
    us, _, up, ut, uts = (torch.from_numpy(np.stack(a)).reshape(
        (2, 3) + a[0].shape).to(cuda) for a in zip(*per))
    wcon = torch.from_numpy(np.stack([per[0][1], per[3][1]])).to(cuda)
    got = vadvc_cuda(us, wcon, up, ut, uts)
    for e in range(2):
        for f in range(3):
            one = vadvc_cuda(us[e, f].contiguous(), wcon[e].contiguous(),
                             up[e, f].contiguous(), ut[e, f].contiguous(),
                             uts[e, f].contiguous())
            assert torch.equal(got[e, f], one)
    assert torch.equal(vadvc_cuda(us, _periodic(wcon), up, ut, uts),
                       vadvc_cuda(us, torch.cat(
                           [_periodic(wcon), wcon[..., :1]], -1), up, ut,
                           uts))
