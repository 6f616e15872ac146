"""A cell, a mix and a per-layer metric added as new files and entries are
found, and run, without editing any file of the benchmark."""

import json
import os

import bench_gpu_tiny as T


def test_new_cell_and_metric_found_and_run(tmp_path):
    here = T.tiny_copy(tmp_path)
    before = {p: open(os.path.join(T.BENCH, p), "rb").read()
              for p in ("run.py", "harness.py", "cells.py", "generator.py")}
    # a new per-layer metric: a file and an entry
    with open(os.path.join(here, "metrics", "jobs_in_window.py"), "w") as fh:
        fh.write("def read(ctx):\n    return float(len(ctx.jobs))\n")
    bench_path = os.path.join(os.path.dirname(here), "BENCHMARK.json")
    with open(bench_path) as fh:
        bench = json.load(fh)
    bench["per_layer"].append({
        "name": "jobs_in_window", "unit": "jobs", "better": "higher",
        "source": "host_clock", "layer": "job set-up (host)",
        "moves": "prove_cycles_per_s",
        "workloads": [T.TINY_CELL["name"]]})
    with open(bench_path, "w") as fh:
        json.dump(bench, fh)

    import cells

    b = cells.load_benchmark(os.path.dirname(here))
    assert cells.find_cell(b, T.TINY_CELL["name"])["traffic"] == "counter-tiny"
    assert cells.load_traffic("counter-tiny", here)["heights"] == \
        T.TINY_TRAFFIC["heights"]
    names = [m["name"] for m in cells.cell_metrics(b, T.TINY_CELL["name"],
                                                   True)]
    assert names == ["jobs_in_window"]
    result = T.tiny_run(here, trace=True)
    assert result["correct"], result
    assert result["metrics"]["jobs_in_window"]["value"] >= 1
    result = T.tiny_run(here)
    assert result["correct"], result
    assert set(result["metrics"]) == {"prove_cycles_per_s", "setup_s"}
    after = {p: open(os.path.join(T.BENCH, p), "rb").read() for p in before}
    assert after == before
