"""End-to-end training example of the PyTorch/CUDA port: train a ~100M-param
LM for a few hundred steps with checkpoint/restart, on the card (the
flash-attention and cross-entropy kernels in the forward, their autograd
Functions in the backward) unless `--device cpu` asks for the plain
versions.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
A quick functional pass on the CPU:
      PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
          --steps 6 --batch 2 --seq 64
Run again with the same `--ckpt-dir` and more `--steps` to resume from the
checkpoint the first run left.
"""

import argparse
from pathlib import Path

from repro_torch.configs.base import ModelConfig
from repro_torch.data import synthetic
from repro_torch.kernels._build import print_launches
from repro_torch.models import api
from repro_torch.train import loop, optim

# ~100M params: 12 layers, d=768 (tinyllama family); param_count() = 129M
CFG_100M = ModelConfig(
    name="demo-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=3072, vocab_size=16384, pattern=("attn",), rope_theta=1e4,
    norm="rms", gated_mlp=True, act="silu")
# checkpoints stay inside the checkout
CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_train_lm"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    cfg = CFG_100M
    model = api.build(cfg, device=args.device)
    n = cfg.param_count()
    print(f"training {cfg.name}: {n / 1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} seq {args.seq} on "
          f"{model.device}")
    data = synthetic.iterator(cfg, args.batch, args.seq, device=model.device)
    opt_cfg = optim.OptConfig(lr=1e-3, warmup_steps=20,
                              total_steps=args.steps)
    try:
        params, _, hist = loop.fit(model, data, steps=args.steps,
                                   opt_cfg=opt_cfg, ckpt_dir=args.ckpt_dir,
                                   ckpt_every=100, log_every=20)
    finally:
        data.close()
    if not hist:
        print(f"checkpoint in {args.ckpt_dir} is already at step "
              f">= {args.steps}; nothing to do (rm -r it to retrain)")
        print_launches()
        print("train_lm OK")
        return
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over "
          f"steps {hist[0]['step']}..{hist[-1]['step']}")
    if len(hist) > 20:
        assert hist[-1]["loss"] < hist[0]["loss"]
    print_launches()
    print("train_lm OK")


if __name__ == "__main__":
    main()
