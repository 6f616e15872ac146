"""Shared pieces of the benchmark's CPU tests: a copy of the benchmark's
folder with a tiny cell added as files and entries, and runs of it on the
CPU (the program's kernels' plain versions, the reference on the CPU)."""

from __future__ import annotations

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_TRAFFIC = {
    "name": "counter-tiny",
    "why": "a counter small enough for a CPU test: FRI 4096",
    "program": [["+", "k"], ["[->", 1], ["+", 2], ["[-]<]", 1]],
    "input": "",
    "draw": {"k": {"cost_from": 48, "cost_below": 64}},
    "heights": [64, 64, 128, 0, 0],
}
TINY_CELL = {"name": "sec2.counter-tiny", "config": "bf-sec2",
             "traffic": "counter-tiny", "chips": 1,
             "why": "a CPU test's cell"}


def tiny_copy(tmp_path) -> str:
    """A copy of the benchmark's folder and BENCHMARK.json under tmp_path,
    with the tiny mix and cell added as a new file and a new entry; returns
    the copy's folder."""
    root = tmp_path / "checkout"
    here = root / "bench_gpu"
    shutil.copytree(BENCH, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(here / "traffic" / "counter-tiny.json", "w") as fh:
        json.dump(TINY_TRAFFIC, fh)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append(dict(TINY_CELL))
    with open(root / "BENCHMARK.json", "w") as fh:
        json.dump(bench, fh)
    return str(here)


def tiny_run(here: str, seed: int = 2**31 + 5, trace: bool = False,
             program=None, seconds: float = 0.5):
    """One CPU run of the tiny cell in the copy at `here`."""
    import cells
    import harness

    bench = cells.load_benchmark(os.path.dirname(here))
    return harness.run(TINY_CELL["name"], seed, seconds, trace,
                       device="cpu", bench=bench, here=here, program=program)
