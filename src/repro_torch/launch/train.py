"""Training launcher: AdamW steps on synthetic data.

    python -m repro_torch.launch.train --arch tinyllama-1.1b
    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu

Trains the architecture at its full published width and depth on the card
(random weights from seed 0) unless `--smoke` asks for the reduced config;
`--device cpu` runs the kernels' plain versions. `--ckpt-dir` checkpoints
every `--ckpt-every` steps and at the end, and resumes from the latest
checkpoint there. The defaults are the JAX launcher's.

Under torchrun (`RANK`/`WORLD_SIZE` set) it trains on a device mesh of the
world, one process a device: ("data", "model") of (1, n) with `--smoke`
(as the JAX launcher's smoke mesh), or `--mesh D,M`, else (n, 1);
`--mesh P,D,M` names ("pod", "data", "model"), the batch split over pod
and data; `--multi-pod` takes the production pod mesh,
`launch/mesh.py::production_shape(multi_pod=True)`, (2, 16, 16), and
refuses any world but 512 (`launch/mesh.py::make_device_mesh`; `--device
cpu` runs gloo):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch tinyllama-1.1b --mesh 2,2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch tinyllama-1.1b --mesh 2,1,2

Rank 0 prints the success line, which names the mesh. `main` returns the
run's history; it ends the process group only where it began it, so a
caller that holds a group can call it again.
"""

from __future__ import annotations

import argparse
import os

from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.launch.mesh import production_shape
from repro_torch.models import api
from repro_torch.train import loop, optim


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="D,M: the (data, model) mesh under torchrun; "
                         "P,D,M: (pod, data, model)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) (pod, data, model) production "
                         "mesh; needs a world of 512")
    args = ap.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    shape = axes = None
    if args.multi_pod:
        if args.mesh:
            ap.error("--multi-pod takes the production mesh; drop --mesh")
        shape, axes = production_shape(multi_pod=True)
        if world != 512:
            ap.error(f"--multi-pod trains on the {shape} (pod, data, model) "
                     f"mesh, 512 processes; WORLD_SIZE is {world}")
    elif args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        if len(shape) not in (2, 3):
            ap.error(f"--mesh {args.mesh}: D,M or P,D,M")
        axes = production_shape(multi_pod=len(shape) == 3)[1]
    elif "WORLD_SIZE" in os.environ:
        shape = (1, world) if args.smoke else (world, 1)
        axes = ("data", "model")

    cfg = registry.get_config(args.arch)
    if args.smoke:
        cfg = registry.reduced_config(cfg)
    mesh, where, say, owns = None, None, print, False
    if shape is not None:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_device_mesh
        from repro_torch.parallel import sharding as shd
        owns = not dist.is_initialized()
        mesh = make_device_mesh(shape, axes, device_type=args.device)
        where = (f"mesh {dict(zip(mesh.mesh_dim_names, shape))} "
                 f"({mesh.device_type})")
        if not shd.is_rank0():
            say = lambda *_: None                       # noqa: E731
    model = api.build(cfg, device=args.device)
    where = where or str(model.device)
    opt_cfg = optim.OptConfig(lr=args.lr, warmup_steps=5,
                              total_steps=args.steps)
    data = synthetic.iterator(cfg, args.batch, args.seq, device=model.device,
                              mesh=mesh)
    _, _, hist = loop.fit(model, data, steps=args.steps, opt_cfg=opt_cfg,
                          microbatches=args.microbatches,
                          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                          mesh=mesh, log_fn=say)
    if not hist:
        say(f"[train] done: the checkpoint in {args.ckpt_dir} is at step "
            f"{args.steps} already; nothing to run on {where}")
    else:
        say(f"[train] done: loss {hist[0]['loss']:.4f} -> "
            f"{hist[-1]['loss']:.4f} over {len(hist)} steps on {where}")
    data.close()
    if owns:
        dist.destroy_process_group()
    return hist


if __name__ == "__main__":
    main()
