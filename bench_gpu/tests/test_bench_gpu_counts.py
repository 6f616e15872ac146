"""A cell's own job counts (`workloads/<cell>.json`) win over its
configuration's; the cells without such a file keep their configuration's;
and the north star's mix `counter-2e20` keeps its range and heights."""

import json
import os

import pytest

import bench_gpu_tiny as T
import cells
import generator

import stark_brainfuck_tpu_torch as P


@pytest.mark.parametrize("cell, counts", [
    ("sec2.counter-2e15", {"reprove_jobs": 6, "profile_jobs": 4}),
    ("sec160.counter-2e15", {"reprove_jobs": 2, "profile_jobs": 1}),
    ("sec2.counter-2e20", {"reprove_jobs": 1, "profile_jobs": 1}),
])
def test_the_cells_counts(cell, counts):
    bench = cells.load_benchmark(T.ROOT)
    config = cells.load_config(cells.find_cell(bench, cell)["config"])
    assert cells.job_counts(cell, config) == counts


def test_a_cells_own_counts_win(tmp_path):
    here = T.tiny_copy(tmp_path)
    config = cells.load_config("bf-sec2", here)
    name = T.TINY_CELL["name"]
    assert cells.job_counts(name, config, here) == {
        "reprove_jobs": config["reprove_jobs"],
        "profile_jobs": config["profile_jobs"]}
    with open(os.path.join(here, "workloads", name + ".json"), "w") as fh:
        json.dump({"name": name, "reprove_jobs": 1}, fh)
    assert cells.job_counts(name, config, here) == {
        "reprove_jobs": 1, "profile_jobs": config["profile_jobs"]}
    result = T.tiny_run(here)
    assert result["correct"], result
    assert result["checks"]["proofs_compared"]["value"] == 1


@pytest.fixture(scope="module")
def mix():
    with open(os.path.join(T.BENCH, "traffic", "counter-2e20.json")) as fh:
        return json.load(fh)


def test_counter_2e20_range(mix):
    lo, hi = generator.drawn_range(mix)
    assert (lo, hi) == (7635, 10179)
    draw = mix["draw"]["k"]
    for k, inside in ((lo - 1, False), (lo, True), (hi, True),
                      (hi + 1, False)):
        c = generator.cost(generator.program_source(mix["program"],
                                                    {"k": k}), "")
        assert (draw["cost_from"] <= c < draw["cost_below"]) == inside


@pytest.mark.parametrize("k", [7635, 10179])
def test_counter_2e20_heights(mix, k):
    program = P.VirtualMachine.compile(
        generator.program_source(mix["program"], {"k": k}))
    trace = P.VirtualMachine.simulate(program)
    prover = P.BrainfuckStark(trace["processor"].shape[0],
                              trace["memory"].shape[0], program, "", "",
                              P.StarkConfig(), device="cpu")
    assert [t.height for t in prover.tables] == mix["heights"]
    assert prover.fri.domain.length == 1 << 26
