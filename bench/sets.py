"""Sets of runs of one cell, each a fresh process, and their spreads.

    python3 bench/sets.py --workload <cell> --seeds 1,2,... --seconds 10 \
        [--trace 0] [--out FILE]

Runs `bench/run.py` once per seed, one after another, appends each run's
last line (with its seed and exit code) to `--out`, and prints for each
metric the median and the spread: the distance between the first and the
third quartile (`statistics.quantiles(values, n=4)`) over the median. The
benchmark's own runs never run this; it is how the bounds were measured.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    mid = statistics.median(values)
    if len(values) < 2 or mid == 0:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / mid


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
               args.workload, "--seed", seed, "--seconds", args.seconds,
               "--trace", args.trace]
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        row = {"seed": int(seed), "rc": p.returncode,
               "split": next((json.loads(x.split(" ", 1)[1]) for x in lines
                              if x.startswith("setup_split ")), None)}
        try:
            row["result"] = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            row["stderr"] = p.stderr[-3000:]
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    ok = [r["result"] for r in rows if "result" in r]
    names = sorted({k for r in ok for k in r["metrics"]})
    summary = {"workload": args.workload, "runs": len(rows),
               "correct": sum(bool(r["correct"]) for r in ok)}
    for name in names:
        vals = [r["metrics"][name]["value"] for r in ok
                if name in r["metrics"]]
        summary[name] = {"median": statistics.median(vals),
                         "spread": spread(vals), "values": vals}
    print("summary " + json.dumps(summary), flush=True)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
