"""Quickstart of the PyTorch/CUDA port: the paper's two kernels through the
port's engine layers.

1. Run the hdiff + vadvc plain versions on the paper's 256x256x64 domain.
2. Auto-tune the 3-D window (paper Fig. 6) under the H100 spec and show
   the chosen plan.
3. Hold the CUDA kernels (`hdiff_cuda`, `vadvc_cuda`) against their plain
   versions on the card; with `--device cpu`, hold the plain versions
   against float64 numpy oracles (`vadvc_np`, and Algorithm 1 without the
   limiter for `hdiff_simple`).
4. Compile declarative programs — hdiff-only, vadvc-only, and the fused
   dycore, each a registered StencilOp — into ExecutionPlans
   (`repro_torch.weather.program.compile`) and advance them.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import hierarchy, tiling
from repro_torch.core.autotune import tune
from repro_torch.kernels._build import print_launches
from repro_torch.kernels.hdiff import ref as href
from repro_torch.kernels.vadvc import ref as vref

# the kernel tests' fp32 tolerances (tests/test_kernels_{hdiff,vadvc}.py)
HDIFF_TOL, VADVC_TOL = 1e-5, 2e-4


def hdiff_simple_np(src: np.ndarray, coeff: float = href.DEFAULT_COEFF):
    """Algorithm 1 without the limiter, in float64 numpy: the halo-2 ring
    passes through."""
    f = np.asarray(src, np.float64)
    ny, nx = f.shape[-2:]

    def s(dj, di):
        return f[..., 2 + dj:ny - 2 + dj, 2 + di:nx - 2 + di]

    def lap(dj, di):
        return (s(dj, di - 1) + s(dj, di + 1) + s(dj - 1, di)
                + s(dj + 1, di) - 4.0 * s(dj, di))

    c = lap(0, 0)
    div = (lap(0, 1) - c) - (c - lap(0, -1)) + (lap(1, 0) - c) - (
        c - lap(-1, 0))
    out = f.copy()
    out[..., 2:-2, 2:-2] = s(0, 0) - coeff * div
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    rng = np.random.default_rng(0)
    nz, ny, nx = grid = (64, 256, 256)
    print(f"== NERO quickstart (PyTorch port) on the paper's {nx}x{ny}x{nz} "
          f"domain, device {dev} ==")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    src = put(rng.normal(size=grid).astype(np.float32))
    out = href.hdiff(src)
    print(f"hdiff: out[2,2,2]={float(out[2, 2, 2]):+.4f} "
          f"finite={bool(torch.isfinite(out).all())}")

    us, up, ut, uts = (put(rng.normal(size=grid).astype(np.float32))
                       for _ in range(4))
    wcon = put(rng.uniform(-0.2, 0.2, size=(nz, ny, nx + 1))
               .astype(np.float32))
    adv = vref.vadvc(us, wcon, up, ut, uts)
    res = vref.tridiagonal_residual(us, wcon, up, ut, uts, adv)
    print(f"vadvc: tridiagonal residual {res:.2e} (solves the system)")

    near = hierarchy.h100_sxm().vmem.capacity_bytes   # shared memory a block
    for op, dtype in ((tiling.VADVC, "float32"), (tiling.VADVC, "bfloat16")):
        t = tune(op, grid, dtype)
        pct = 100 * t.plan.vmem_bytes / near
        print(f"autotuned {op.name}/{dtype}: tile={t.plan.tile} "
              f"smem={pct:.0f}% model_gflops={t.est.gflops:.0f}")

    # the kernels on the card against their plain versions; on the CPU the
    # plain versions against float64 numpy oracles
    small = (8, 32, 32)
    s2 = put(rng.normal(size=small).astype(np.float32))
    f = [put(rng.normal(size=small).astype(np.float32)) for _ in range(4)]
    w2 = put(rng.uniform(-0.2, 0.2, size=(8, 32, 33)).astype(np.float32))
    if dev.type == "cuda":
        from repro_torch.kernels.hdiff.hdiff import hdiff_cuda
        from repro_torch.kernels.vadvc.vadvc import vadvc_cuda

        err = float((hdiff_cuda(s2) - href.hdiff(s2)).abs().max())
        print(f"cuda hdiff vs plain version: max err {err:.2e}")
        assert err <= HDIFF_TOL, err
        got = vadvc_cuda(f[0], w2, f[1], f[2], f[3])
        err = float((got - vref.vadvc(f[0], w2, f[1], f[2], f[3]))
                    .abs().max())
        print(f"cuda vadvc vs plain version: max err {err:.2e}")
        assert err <= VADVC_TOL, err
    else:
        err = float(np.abs(href.hdiff_simple(s2).numpy()
                           - hdiff_simple_np(s2.numpy())).max())
        print(f"plain hdiff_simple vs numpy oracle: max err {err:.2e}")
        assert err <= HDIFF_TOL, err
        got = vref.vadvc(f[0], w2, f[1], f[2], f[3]).numpy()
        err = float(np.abs(got - vref.vadvc_np(f[0], w2, f[1], f[2],
                                               f[3])).max())
        print(f"plain vadvc vs vadvc_np: max err {err:.2e}")
        assert err <= VADVC_TOL, err

    # Declarative programs over registered stencil ops: the spec says what
    # (op, grid, fields, k-step policy); compile resolves how (variant,
    # kernel tile, launches a round) once. The paper's two kernels are
    # programs of their own.
    from repro_torch.weather import fields as wfields
    from repro_torch.weather.program import (DycoreProgram, StencilProgram,
                                             compile)
    st = wfields.initial_state(torch.Generator().manual_seed(0), small,
                               device=dev)
    hplan = compile(StencilProgram(grid_shape=small, op="hdiff"), device=dev)
    hrep = hplan.report()
    print(f"compile(op=hdiff): variant={hrep['variant']} "
          f"launches/round={hrep['pallas_calls_per_round']} "
          f"footprint={hrep['footprint']['rides'][0]['depth_y']} "
          f"model_gflops={hrep['model']['gflops']:.0f}")
    st = hplan.step(st)
    vplan = compile(StencilProgram(grid_shape=small, op="vadvc"), device=dev)
    vrep = vplan.report()
    print(f"compile(op=vadvc): variant={vrep['variant']} "
          f"wcon ride={vrep['footprint']['rides'][0]['depth_x']} "
          f"model_gflops={vrep['model']['gflops']:.0f}")
    st = vplan.step(st)
    plan = compile(DycoreProgram(grid_shape=small, variant="kstep",
                                 k_steps=2), device=dev)
    rep = plan.report()
    tile = (rep["tile"]["ty"], rep["tile"]["tx"])     # the CUDA block tile
    print(f"compile(op=dycore): variant={rep['variant']} "
          f"k_steps={rep['k_steps']} tile={tile} "
          f"launches/round={rep['pallas_calls_per_round']}")
    st = plan.run(st, 3)   # 1 k-step round + a ragged 1-step tail round
    ok = bool(torch.isfinite(st.fields["t"]).all())
    print(f"plan.run(3 steps): finite={ok}")

    # Chain registered ops into one plan: one launch a stage in order on
    # resident operands, bit-identical to the solo programs.
    from repro_torch.weather.pipeline import PipelineProgram
    pplan = compile(PipelineProgram(
        grid_shape=small, coeff=0.05,
        stages=("hadv_upwind", "vadvc_update", "hdiff")), device=dev)
    prep = pplan.report()
    print(f"compile(pipeline): stages=3 "
          f"launches/round={prep['pallas_calls_per_round']} "
          f"merged fields ride="
          f"{prep['footprint']['rides'][0]['depth_y']} "
          f"hbm_reduction={prep['traffic']['chained_reduction_x']:.2f}x")
    st = pplan.step(st)
    assert ok and bool(torch.isfinite(st.fields["t"]).all())
    print_launches()
    print("quickstart OK")


if __name__ == "__main__":
    main()
