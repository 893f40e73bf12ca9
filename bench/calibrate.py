"""Readings that a cell's limits of the correctness check are set from.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--growth 1000] [--trajectory 1,2] [--out FILE]

For each seed, in one process: set-up as a run makes it, the cell's
kind's `KEPT_FORECASTS` forecasts through the timed path, and the check's
numbers (`Workload.check`) against the plain reference, as a run reads
them. For each control seed also the control's numbers: the program's
own bfloat16 path, one precision below the configuration's float32, in
the program's place (`Workload.control`). With `--growth N`, the
program's forecast is chained for N steps from the first seed's first
state and the largest |value| of the fields and of the stage tendencies
is printed every 50 steps; with
`--trajectory`, the check's numbers between the program and the
reference run side by side, after 1, 5, 25, 50, ... steps. Each
reading is one JSON line on standard output (and appended to `--out`).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import os
import sys

if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(
        os.path.abspath(__file__)):
    del sys.path[0]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(root, name, seed, control, device="cuda"):
    """One seed's program reading and, with `control`, the control's."""
    from bench import manifest
    cell = manifest.cell(root, name)
    kind = manifest.traffic_kind(cell)
    wl = kind.Workload(cell, seed, device)
    wl.draw_inputs()
    wl.compile()
    wl.warm_up()
    t0 = time.perf_counter()
    for _ in range(kind.KEPT_FORECASTS):
        wl.one()
    program_s = time.perf_counter() - t0
    wl.release()
    t0 = time.perf_counter()
    got = wl.check()
    out = {"workload": name, "seed": seed, "program": got["numbers"],
           "answers": got["answers"], "program_s": program_s,
           "check_s": time.perf_counter() - t0, "limits": cell.limits}
    if control:
        out["control"] = wl.check(control=True)["numbers"]
    return out


def trajectory(root, name, seed, device="cuda"):
    """The check's numbers between the program and the reference, both run
    from the same initial state, after 1, 5, 25, 50, ... steps up to the
    mix's forecast: how a gap that starts at rounding grows."""
    from bench import inputs, manifest
    cell = manifest.cell(root, name)
    kind = manifest.traffic_kind(cell)
    wl = kind.Workload(cell, seed, device)
    wl.draw_inputs()
    wl.compile()
    state = wl.program_states[0]
    ref = inputs.members_of(wl.pool[0], wl.checked)
    marks = sorted({1, 5} | set(range(25, wl.steps + 1, 25)))
    rows, done = [], 0
    for mark in marks:
        state = wl.plan.run(state, mark - done)
        ref = wl.reference_steps(ref, mark - done)
        done = mark
        gaps = kind.leaf_gaps(wl._members(state), ref)
        rows.append([mark] + [max(gaps[k]) for k in kind.NUMBERS])
    return {"workload": name, "seed": seed, "trajectory": rows}


def growth(root, name, seed, steps, device="cuda"):
    """Largest |fields| and |stage tendencies| every 50 chained steps."""
    from bench import manifest
    cell = manifest.cell(root, name)
    wl = manifest.traffic_kind(cell).Workload(cell, seed, device)
    wl.draw_inputs()
    wl.compile()
    state, rows = wl.program_states[0], []
    for done in range(50, steps + 1, 50):
        state = wl.plan.run(state, 50)
        big = lambda d: max(float(t.abs().max()) for t in d.values())
        rows.append([done, big(state.fields), big(state.stage_tens)])
        if not math.isfinite(rows[-1][1]):
            break
    return {"workload": name, "seed": seed, "growth": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--growth", type=int, default=0)
    ap.add_argument("--trajectory", default="",
                    help="seeds whose gap is followed step by step")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}

    def emit(d):
        line = json.dumps(d)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    if args.growth:
        emit(growth(ROOT, args.workload, (seeds or sorted(control))[0],
                    args.growth))
        gc.collect()
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.trajectory.split(",") if s]:
        emit(trajectory(ROOT, args.workload, seed))
        gc.collect()
        torch.cuda.empty_cache()
    for seed in seeds + sorted(control - set(seeds)):
        emit(readings(ROOT, args.workload, seed, seed in control))
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
