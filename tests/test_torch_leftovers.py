"""The port's last public names against the JAX package's, on the same
seeded numpy inputs: `hdiff(limit=False)` and `hdiff_simple` (1e-5 in
fp32), `vadvc_np` (1e-12 in float64) and `tridiagonal_residual`, the
`DycoreProgram` / `compile_dycore` aliases, `core/hierarchy.py`'s
module constants and its POWER9 deprecation shims, and
`Model.decode_step(frames_enc=)` on the reduced whisper config (the
encoder-decoder tests' tolerance, 1e-5 of the largest logit)."""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.core import hierarchy as jhier
from repro.kernels.hdiff import ref as jhref
from repro.kernels.vadvc import ref as jvref
from repro.models import api as japi
from repro.weather import program as jprog
from repro_torch.configs import registry as treg
from repro_torch.core import hierarchy as thier
from repro_torch.data import synthetic
from repro_torch.kernels.hdiff import ref as thref
from repro_torch.kernels.vadvc import ref as tvref
from repro_torch.models import api, convert
from repro_torch.weather import program as tprog

TOL_HDIFF = 1e-5
TOL_NP = 1e-12
GRIDS = [(3, 8, 8), (5, 13, 21), (9, 32, 32)]
HIER_NAMES = ["PEAK_BF16_FLOPS", "PEAK_FP32_FLOPS", "HBM_BYTES", "HBM_BW",
              "ICI_BW_PER_LINK", "ICI_LINKS", "VMEM_BYTES", "VMEM_USABLE",
              "VMEM_BW", "VREG_BYTES", "MXU_TILE", "VPU_LANES",
              "ENERGY_PJ_PER_BYTE", "ENERGY_PJ_PER_FLOP_BF16",
              "CHIP_IDLE_WATTS", "CHIP_PEAK_WATTS"]


def _fields(grid, seed):
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid
    f = [rng.normal(size=grid).astype(np.float32) for _ in range(4)]
    wcon = rng.uniform(-0.2, 0.2, size=(nz, ny, nx + 1)).astype(np.float32)
    return f, wcon


@pytest.mark.parametrize("grid", GRIDS)
def test_hdiff_without_the_limiter_matches_jax(grid):
    src = np.random.default_rng(1).normal(size=grid).astype(np.float32)
    want = np.asarray(jhref.hdiff(jnp.asarray(src), limit=False))
    got = thref.hdiff(torch.from_numpy(src), limit=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_HDIFF)
    simple = thref.hdiff_simple(torch.from_numpy(src)).numpy()
    np.testing.assert_allclose(
        simple, np.asarray(jhref.hdiff_simple(jnp.asarray(src))), rtol=0,
        atol=TOL_HDIFF)
    assert np.array_equal(simple, got)
    # the limiter does bite on white noise: limit=True is another result
    limited = thref.hdiff(torch.from_numpy(src)).numpy()
    assert float(np.abs(limited - got).max()) > 1e-3


@pytest.mark.parametrize("grid", GRIDS)
def test_vadvc_np_matches_jax(grid):
    f, wcon = _fields(grid, 2)
    want = jvref.vadvc_np(f[0], wcon, f[1], f[2], f[3])
    got = tvref.vadvc_np(*(torch.from_numpy(x) for x in
                           (f[0], wcon, f[1], f[2], f[3])))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_NP)
    # arrays work as well as tensors
    np.testing.assert_array_equal(
        tvref.vadvc_np(f[0], wcon, f[1], f[2], f[3]), got)


@pytest.mark.parametrize("grid", GRIDS)
def test_tridiagonal_residual_of_the_plain_vadvc(grid):
    f, wcon = _fields(grid, 3)
    t = [torch.from_numpy(x) for x in (f[0], wcon, f[1], f[2], f[3])]
    out = tvref.vadvc(*t)
    res = tvref.tridiagonal_residual(*t, out)
    assert res < 1e-4
    assert res == pytest.approx(jvref.tridiagonal_residual(
        f[0], wcon, f[1], f[2], f[3], out.numpy()), rel=1e-12, abs=1e-15)
    # a wrong output leaves a residual
    assert tvref.tridiagonal_residual(*t, out + 0.01) > 1e-3
    np.testing.assert_allclose(out.numpy(), tvref.vadvc_np(*t), rtol=0,
                               atol=2e-4)


def test_dycore_aliases():
    assert tprog.DycoreProgram is tprog.StencilProgram
    assert tprog.compile_dycore is tprog.compile
    assert {"DycoreProgram", "compile_dycore"} <= set(tprog.__all__)
    assert jprog.DycoreProgram is jprog.StencilProgram
    prog = tprog.DycoreProgram(grid_shape=(3, 8, 8))
    assert prog.op == "dycore"
    assert prog.to_json() == jprog.DycoreProgram(grid_shape=(3, 8, 8)) \
        .to_json()
    plan = tprog.compile_dycore(prog, device="cpu")
    assert plan.report()["op"] == "dycore"


@pytest.mark.parametrize("name", HIER_NAMES)
def test_hierarchy_constant_matches_jax(name):
    got, want = getattr(thier, name), getattr(jhier, name)
    if isinstance(want, (tuple, list)):
        got, want = tuple(got), tuple(want)
    assert got == want


@pytest.mark.parametrize("name", ["POWER9_PEAK_FLOPS", "POWER9_DRAM_BW"])
def test_power9_names_warn_and_match_jax(name):
    with pytest.warns(DeprecationWarning, match="power9"):
        got = getattr(thier, name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = getattr(jhier, name)
    assert got == want
    with pytest.raises(AttributeError):
        thier.NOT_A_NAME


def test_decode_step_frames_enc_matches_jax():
    """Prefill on one batch's frames, then decode steps whose
    `frames_enc` is another batch's encoder output: the logits equal the
    JAX package's, the returned cache carries `frames_enc`, and the
    logits differ from those over the cache's own encoder states."""
    jcfg, tcfg = (dataclasses.replace(
        reg.reduced_config(reg.get_config("whisper-medium")),
        dtype="float32", param_dtype="float32") for reg in (jreg, treg))
    jm, tm = japi.build(jcfg), api.build(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    b0 = synthetic.lm_batch(tcfg, 0, 0, 2, 9)
    b1 = synthetic.lm_batch(tcfg, 1, 0, 2, 9)
    from repro.models import encdec as jencdec
    enc1 = np.array(jencdec.encode(jcfg, jp, jnp.asarray(b1["frames"])))
    _, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in b0.items()},
                       max_len=16)
    with torch.inference_mode():
        _, tc = tm.prefill(tp, {k: torch.from_numpy(v)
                                for k, v in b0.items()}, max_len=16)
        for pos in (9, 10):
            tok = b0["tokens"][:, pos - 9:pos - 8]
            want, jc = jm.decode_step(jp, jc, jnp.asarray(tok), pos,
                                      frames_enc=jnp.asarray(enc1))
            # over the cache's own encoder states (b0's at the first step;
            # the token's K/V, written in place, are the same either way)
            own, _ = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
            got, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), pos,
                                     frames_enc=torch.from_numpy(enc1))
            want = np.asarray(want)
            err = float(np.abs(got.numpy() - want).max())
            assert err <= 1e-5 * float(np.abs(want).max()), err
            assert np.array_equal(tc["enc"].numpy(), enc1)
            assert (float((own - got).abs().max()) > 1e-3) == (pos == 9)
