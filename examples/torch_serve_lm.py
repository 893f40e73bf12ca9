"""End-to-end serving example of the PyTorch/CUDA port: batched requests
through prefill + decode with continuous slot batching (the reduced
gemma3 config exercises the local:global ring-buffer cache path). On the
card prefill and decode run the hand-written flash-attention kernel;
`--device cpu` runs its plain version.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py
      PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.kernels._build import print_launches
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    cfg = registry.reduced_config(registry.get_config(args.arch))
    model = api.build(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    print(f"serving reduced {args.arch}: "
          f"{cfg.param_count() / 1e6:.1f}M params (smoke scale) on "
          f"{model.device}")

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(
                        0, cfg.vocab_size,
                        size=int(rng.integers(4, 12))).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    engine = ServeEngine(model, params, batch=args.batch, max_len=64,
                         device=model.device)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    dt = time.perf_counter() - t0
    total_new = sum(len(v) for v in results.values())
    for rid in sorted(results):
        print(f"req {rid}: {results[rid][:8]}...")
    print(f"{len(results)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s)")
    assert len(results) == args.requests
    print_launches()
    print("serve_lm OK")


if __name__ == "__main__":
    main()
