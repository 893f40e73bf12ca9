"""Training launcher: AdamW steps on synthetic data.

    python -m repro_torch.launch.train --arch tinyllama-1.1b
    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu

Trains the architecture at its full published width and depth on the card
(random weights from seed 0) unless `--smoke` asks for the reduced config;
`--device cpu` runs the kernels' plain versions. `--ckpt-dir` checkpoints
every `--ckpt-every` steps and at the end, and resumes from the latest
checkpoint there. The defaults are the JAX launcher's. Meshes are not
ported.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import registry
from repro_torch.data import synthetic
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
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch)
    if args.smoke:
        cfg = registry.reduced_config(cfg)
    model = api.build(cfg, device=args.device)
    opt_cfg = optim.OptConfig(lr=args.lr, warmup_steps=5,
                              total_steps=args.steps)
    data = synthetic.iterator(cfg, args.batch, args.seq, device=model.device)
    _, _, hist = loop.fit(model, data, steps=args.steps, opt_cfg=opt_cfg,
                          microbatches=args.microbatches,
                          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    if not hist:
        print(f"[train] done: the checkpoint in {args.ckpt_dir} is at step "
              f"{args.steps} already; nothing to run on {model.device}")
        return
    print(f"[train] done: loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f} over {len(hist)} steps on {model.device}")


if __name__ == "__main__":
    main()
