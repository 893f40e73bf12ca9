"""PyTorch port of vadvc against the JAX package's kernel and oracles.

The same numpy inputs go through `repro.kernels.vadvc.vadvc.vadvc_pallas`
(interpret mode), the numpy oracle `vadvc_np` and the port's `ops.vadvc` on
the CPU (its plain version), at the reference's tolerance of 2e-4
(`tests/test_kernels_vadvc.py`). The `cuda` cases hold the CUDA kernel
against the plain version on the card.
"""

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
    other = vadvc_cuda(*args, tile=tiling.vadvc_tile(37, 70, tj=4, ti=64))
    assert torch.equal(other, got)


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
