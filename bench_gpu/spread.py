"""Runs of one cell, each a process of its own, and the spread of each
metric over them: how a bound is set.

    python3 bench_gpu/spread.py --workload NAME --seconds S --trace 0 \
        --seeds A B C ... [--sets 2] [--out DIR]

runs `run.py` once for each seed, and again in each further set with the
same seeds, one run after another. It prints each run's result line and,
for each set and metric, the median, the quartiles (Python's
`statistics.quantiles(values, n=4)`) and the spread, their distance as a
share of the median; and each set's runs whose `correct` is not true. With
`--out`, each run's output and errors are kept there.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values):
    """(median, q1, q3, (q3 - q1) / median)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return med, q1, q3, (q3 - q1) / med if med else float("nan")


def one_run(workload, seed, seconds, trace, out_dir, tag):
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.time() - t0
    if out_dir:
        base = os.path.join(out_dir, f"{workload}.{tag}.{seed}")
        with open(base + ".out", "w") as fh:
            fh.write(proc.stdout)
        with open(base + ".err", "w") as fh:
            fh.write(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
        window = next((json.loads(x)["window"] for x in lines[:-1]
                       if x.startswith('{"window"')), None)
    except (ValueError, IndexError):
        result, window = None, None
    return proc.returncode, wall, result, window, proc.stderr[-3000:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for s in range(args.sets):
        values, bad = {}, []
        for seed in args.seeds:
            rc, wall, result, window, err = one_run(
                args.workload, seed, args.seconds, args.trace, args.out,
                f"set{s}")
            print(json.dumps({"set": s, "seed": seed, "rc": rc,
                              "wall_s": wall, "result": result,
                              "window": window}), flush=True)
            if result is None or not result.get("correct"):
                bad.append(seed)
                print(err, file=sys.stderr, flush=True)
                continue
            for name, m in result["metrics"].items():
                values.setdefault(name, []).append(m["value"])
        summary = {}
        for name, vs in values.items():
            if len(vs) >= 2:
                med, q1, q3, sp = spread(vs)
                summary[name] = {"n": len(vs), "median": med, "q1": q1,
                                 "q3": q3, "spread": sp, "values": vs}
        print(json.dumps({"set": s, "workload": args.workload,
                          "not_correct": bad, "spread": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
