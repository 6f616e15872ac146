"""The reference's class path gives the bytes of its resident path and of
the program's streamed prover, at a small domain on the CPU, with its
threshold set low through its argument."""

import json
import os

import pytest

import bench_gpu_tiny as T
import judge
from reference import bfstark as R
from reference.bfstark.protocol import classes as RC

import stark_brainfuck_tpu_torch as P

SOURCE = "+++[->++[-]<]"
SEED = 2**33 + 5


def config(name):
    with open(os.path.join(T.BENCH, "configs", f"{name}.json")) as fh:
        return json.load(fh)["stark"]


def matrices(vm):
    program = vm.compile(SOURCE)
    trace = vm.simulate(program)
    return program, trace


def port_streamed(stark, classes):
    program, trace = matrices(P.VirtualMachine)
    prover = P.BrainfuckStark(
        trace["processor"].shape[0], trace["memory"].shape[0], program, "",
        trace["output_data"],
        P.StarkConfig(seed=SEED, stream_min=1, stream_classes=classes,
                      **stark),
        device="cpu")
    proof = prover.prove(trace["processor"], trace["memory"],
                         trace["instruction"], trace["input"],
                         trace["output"])
    assert prover.last_metrics["stream_classes"] == classes
    return proof


@pytest.fixture(scope="module")
def resident():
    return {name: judge.reference_proof(SOURCE, "", SEED, config(name), "cpu")
            for name in ("bf-sec2", "bf-sec160")}


@pytest.mark.parametrize("name", ["bf-sec2", "bf-sec160"])
@pytest.mark.parametrize("classes", [2, 4, 8])
def test_class_bytes_are_the_resident_and_the_program_bytes(resident, name,
                                                            classes):
    stark = config(name)
    got = judge.reference_proof(SOURCE, "", SEED, stark, "cpu",
                                resident_max=1, classes=classes)
    assert judge.bytes_differing(got, resident[name]) == 0
    assert judge.bytes_differing(port_streamed(stark, classes), got) == 0


def prover(stark, **kw):
    program, trace = matrices(R.VirtualMachine)
    p = RC.ClassStark(trace["processor"].shape[0], trace["memory"].shape[0],
                      program, "", trace["output_data"],
                      R.StarkConfig(seed=SEED, **stark), device="cpu", **kw)
    return p, trace


def test_the_threshold_chooses_the_path(resident, monkeypatch):
    """At and below `resident_max` the resident path proves; above it the
    class path does."""
    calls = []
    real = RC.prove_in_classes
    monkeypatch.setattr(RC, "prove_in_classes",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    stark = config("bf-sec2")
    for resident_max, taken in ((None, []), ("domain", []),
                                ("below", [{"classes": 2}])):
        p, trace = prover(stark, classes=2)
        N = p.fri.domain.length
        p.resident_max = {None: RC.RESIDENT_MAX, "domain": N,
                          "below": N - 1}[resident_max]
        calls.clear()
        got = p.prove(trace["processor"], trace["memory"],
                      trace["instruction"], trace["input"], trace["output"])
        assert calls == taken
        assert judge.bytes_differing(got, resident["bf-sec2"]) == 0


def test_the_default_class_size():
    p, _ = prover(config("bf-sec2"))
    cl = RC.Classes(p)
    assert cl.C == max(1, p.fri.domain.length // RC.CLASS_SIZE)
    assert RC.RESIDENT_MAX == 1 << 24 and RC.CLASS_SIZE == 1 << 21


@pytest.mark.parametrize("classes", [3, "domain"])
def test_a_class_count_that_does_not_split_is_refused(classes):
    """Three classes do not split the domain; as many classes as points
    would put a table's next row in another class."""
    p, _ = prover(config("bf-sec2"))
    count = p.fri.domain.length if classes == "domain" else classes
    with pytest.raises(ValueError):
        RC.Classes(p, count)
