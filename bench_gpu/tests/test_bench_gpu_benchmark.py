"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units, bounds and references, and each cell's files."""

import json
import os
import re

import pytest

import bench_gpu_tiny as T
import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark(T.ROOT)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(T.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cellnames = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and line(w["why"])
        assert w["config"] in names
        cellnames.add(w["name"])
    assert len(cellnames) == len(bench["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    metric_names = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            assert set(m.get("workloads", [])) <= cellnames
            metric_names.append(m["name"])
    assert len(set(metric_names)) == len(metric_names)


def test_end_to_end(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        reported = [m for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2


def test_per_layer(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"])
        assert m["moves"] in e2e
        cells_of = m.get("workloads", [w["name"] for w in bench["workloads"]])
        moved = e2e[m["moves"]].get("workloads")
        assert moved is None or set(cells_of) <= set(moved)
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for w in bench["workloads"]:
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in bench["per_layer"])


def test_every_piece_has_its_file(bench):
    here = T.BENCH
    for c in bench["configs"]:
        assert c["file"] == f"bench_gpu/configs/{c['name']}.json"
        with open(os.path.join(T.ROOT, c["file"])) as fh:
            data = json.load(fh)
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(here, "traffic",
                                           w["traffic"] + ".json"))
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert callable(cells.reader(m["name"]))


def test_four_chip_cells_at_most_a_quarter(bench):
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
