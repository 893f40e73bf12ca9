"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The program under test is the PyTorch
and CUDA package `repro_torch` under `src/`; nothing here loads the JAX
package or JAX. The last line of standard output is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
also `breakdown`, and last `check`: each number compared beside its
limit); the line before it splits the set-up. The last lines of standard
error repeat the numbers compared. Without a CUDA device the run exits 2
and prints no result; with a JAX module loaded at its end, 3.
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()
# run as a script, this folder is first on the path; its modules are
# imported as the `bench` package instead
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(
        os.path.abspath(__file__)):
    del sys.path[0]

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    # the program's caches stay in the checkout, at fixed paths
    os.environ.setdefault("REPRO_TUNE_CACHE",
                          str(ROOT / "build" / "bench" / "tune"))

    import torch
    split = {"import_torch_s": time.perf_counter() - T_START}
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    import repro_torch.weather.program  # noqa: F401
    from bench import harness
    split["import_program_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.init()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    split["cuda_context_s"] = time.perf_counter() - t0

    done = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda",
                            t_start=T_START, split=split)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded modules of the JAX stack or the JAX package: "
              f"{banned}", file=sys.stderr)
        return 3
    result = done["result"]
    print("answer_gaps " + json.dumps(done["answers"]), flush=True)
    print("setup_split " + json.dumps(done["setup_split"]), flush=True)
    for key, v in result["check"].items():
        print(f"check {key} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
