"""End-to-end weather example of the PyTorch/CUDA port: an ensemble dycore
simulation with the paper's compound kernels, optionally
domain-decomposed over a mesh.

The execution strategy comes from ONE declarative plan
(`repro_torch.weather.program.compile_dycore`): the spec names the grid,
ensemble and policies; the planner resolves the variant (whole-state
fused / in-kernel k-step / unfused plain composition via `--no-fused`),
the kernel tile, the steps-per-round depth (`--k-steps`, `auto` lets the
exchange model pick) and, on a mesh, the packed halo-exchange schedule.
`plan.run` advances any step count (a shorter tail round covers
`steps % k`). On the card every step launches the hand-written CUDA
kernels; `--device cpu` runs their plain versions.

`--mesh 2,2` decomposes the domain over a ("data", "model") mesh driven
from this process (`launch/mesh.py::make_mesh`). Where the machine has
fewer cards than shards, the mesh lists the card once for each shard
(`["cuda:0"] * 4`) and says so: the shards then share one card, and a
halo ride is a copy on it. The mesh round is the single-device plan bit
for bit on the card, so the final energies of the two runs are equal.

Run:  PYTHONPATH=src python examples/torch_weather_simulation.py --steps 10
      PYTHONPATH=src python examples/torch_weather_simulation.py --mesh 2,2
      PYTHONPATH=src python examples/torch_weather_simulation.py --device cpu
"""

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.kernels._build import print_launches
from repro_torch.launch.mesh import make_mesh
from repro_torch.weather import domain, fields
from repro_torch.weather.program import DycoreProgram, compile_dycore


def mesh_devices(shape, dev: torch.device):
    """The devices of a mesh of `shape`: the card's own where it has
    enough, else `dev` listed once a shard (said on stdout)."""
    n = math.prod(shape)
    have = torch.cuda.device_count() if dev.type == "cuda" else 0
    if have >= n:
        return None
    print(f"mesh {shape}: {n} shards on {max(have, 1)} {dev.type} "
          f"device(s); listing {dev} {n} times")
    return [dev] * n


def energy(st) -> float:
    """The fields' sum of squares, in float64 on the host."""
    return float(sum(torch.sum(f.detach().to("cpu", torch.float64) ** 2)
                     for f in st.fields.values()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default="16,64,64")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--ensemble", type=int, default=2)
    ap.add_argument("--mesh", default="",
                    help="e.g. 2,2 -> ('data','model') decomposition")
    ap.add_argument("--k-steps", default="1",
                    help="timesteps per round (int, or 'auto' to let the "
                         "planner resolve the communication-avoiding k)")
    ap.add_argument("--op", default="dycore",
                    choices=("dycore", "hdiff", "vadvc"),
                    help="which registered stencil op to run (the paper "
                         "evaluates hdiff and vadvc separately)")
    ap.add_argument("--no-fused", action="store_true",
                    help="unfused plain composition instead of the fused "
                         "kernel")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    grid = tuple(int(x) for x in args.grid.split(","))
    k_steps = args.k_steps if args.k_steps == "auto" else int(args.k_steps)
    # drawn on the device, as the chip smoke's main path draws its state
    st = fields.initial_state(torch.Generator(device=dev).manual_seed(0),
                              grid, ensemble=args.ensemble, device=dev)
    print(f"grid={grid} ensemble={args.ensemble} steps={args.steps} "
          f"device={dev}")

    if args.op == "vadvc" and k_steps not in (1, "auto"):
        raise SystemExit("vadvc has no k-step round (its footprint does "
                         "not deepen with k); use --k-steps 1")
    program = DycoreProgram(
        grid_shape=grid, ensemble=args.ensemble, op=args.op,
        variant="unfused" if args.no_fused else "auto", k_steps=k_steps)
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        mesh = make_mesh(shape, ("data", "model"),
                         devices=mesh_devices(shape, dev))
        plan = compile_dycore(program, mesh=mesh)
        st = domain.shard_state(st, mesh, plan.state_spec)
        print(f"domain-decomposed over mesh {dict(mesh.shape)}")
    else:
        plan = compile_dycore(program, device=dev)
    rep = plan.report()
    tile = (rep["tile"]["ty"], rep["tile"]["tx"]) if rep["tile"] else None
    print(f"plan: variant={rep['variant']} k_steps={rep['k_steps']} "
          f"tile={tile} launches/round={rep['pallas_calls_per_round']} "
          f"collectives/round={rep['collectives_per_round']}")

    whole = domain.gather_state if args.mesh else (lambda s: s)
    energy0 = energy(whole(st))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = plan.run(st, args.steps)   # full rounds + ragged tail if needed
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    energy1 = energy(whole(st))
    pts = args.ensemble * np.prod(grid) * args.steps
    print(f"{args.steps} steps in {dt:.2f}s "
          f"({pts / dt / 1e6:.1f}M point-updates/s, "
          f"{dt / args.steps * 1e3:.4f} ms a step)")
    print(f"field energy {energy0:.1f} -> {energy1:.1f} "
          f"(diffusion dissipates: {energy1 < energy0})")
    print(f"final field energy {energy1!r}")
    assert np.isfinite(energy1)
    print_launches()
    print("weather simulation OK")


if __name__ == "__main__":
    main()
