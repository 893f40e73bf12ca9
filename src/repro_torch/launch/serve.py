"""Serving launcher: batched requests end to end through `ServeEngine`.

    python -m repro_torch.launch.serve --arch recurrentgemma-9b
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke --device cpu

Runs the architecture at its full published width and depth on the card
(random weights from `--seed`) unless `--smoke` asks for the reduced
config; `--device cpu` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch)
    if args.smoke:
        cfg = registry.reduced_config(cfg)
    model = api.build(cfg, device=args.device)
    params = model.init(
        torch.Generator(device=model.device).manual_seed(args.seed))

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=rng.integers(4, 12)).astype(
                                            np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    engine = ServeEngine(model, params, batch=args.batch,
                         max_len=max(64, 12 + args.max_new),
                         temperature=args.temperature, seed=args.seed,
                         device=args.device)
    results = engine.run(reqs)
    for rid in sorted(results):
        print(f"req {rid}: {results[rid]}")
    print(f"[serve] completed {len(results)} requests on {model.device}")


if __name__ == "__main__":
    main()
