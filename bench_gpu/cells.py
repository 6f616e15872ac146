"""Where a cell's pieces are found, by name.

`BENCHMARK.json`, at the root of the checkout, lists the cells
(`workloads`), the configurations and the metrics. A cell names a
configuration and a traffic mix; each has a file of its own here,
`configs/<name>.json` and `traffic/<name>.json`, and each metric a reader,
`metrics/<name>.py`. A cell may also have `workloads/<cell>.json`, with
the job counts it sets apart from its configuration's. A configuration, a
mix, a cell or a metric is added by adding its file and its entry: nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _load_json(kind: str, name: str, here: str) -> dict:
    with open(os.path.join(here, kind, f"{name}.json")) as fh:
        return json.load(fh)


def load_config(name: str, here: str = HERE) -> dict:
    return _load_json("configs", name, here)


def load_traffic(name: str, here: str = HERE) -> dict:
    return _load_json("traffic", name, here)


# the judge's and the profiler's job counts: a cell's own file gives them
# where it has one, else its configuration does, else 1
JOB_COUNTS = ("reprove_jobs", "profile_jobs")


def job_counts(cell: str, config: dict, here: str = HERE) -> Dict[str, int]:
    """{"reprove_jobs", "profile_jobs"} of the cell `cell` run under the
    configuration `config` (its parsed file)."""
    path = os.path.join(here, "workloads", f"{cell}.json")
    own = {}
    if os.path.exists(path):
        own = _load_json("workloads", cell, here)
    return {k: int(own.get(k, config.get(k, 1))) for k in JOB_COUNTS}


def reader(name: str, here: str = HERE) -> Callable:
    """The `read(ctx)` function of `metrics/<name>.py`."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_gpu_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics, or with
    `trace` its per-layer ones; a metric with a `workloads` key only in the
    cells it lists."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]
