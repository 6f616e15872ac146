"""The generator keeps every job in its bucket, with the reference's
interpreter and the program's alike."""

import json
import os

import pytest

import bench_gpu_tiny as T  # noqa: F401  (puts the benchmark on sys.path)
import generator

import stark_brainfuck_tpu_torch as P

MIX = os.path.join(T.BENCH, "traffic", "counter-2e15.json")


@pytest.fixture(scope="module")
def mix():
    with open(MIX) as fh:
        return json.load(fh)


def port_cost(source):
    program = P.VirtualMachine.compile(source)
    running_time, _, _ = P.VirtualMachine.run(program)
    return running_time + len(program)


def test_range_is_the_bucket(mix):
    lo, hi = generator.parameter_range(mix, "k")
    draw = mix["draw"]["k"]
    assert (lo, hi) == (239, 317)
    for k in (lo, hi):
        c = port_cost(generator.program_source(mix["program"], {"k": k}))
        assert draw["cost_from"] <= c < draw["cost_below"]
    for k in (lo - 1, hi + 1):
        c = port_cost(generator.program_source(mix["program"], {"k": k}))
        assert not draw["cost_from"] <= c < draw["cost_below"]


@pytest.mark.parametrize("k", [239, 317])
def test_ends_pad_to_the_mix_heights(mix, k):
    source = generator.program_source(mix["program"], {"k": k})
    program = P.VirtualMachine.compile(source)
    trace = P.VirtualMachine.simulate(program)
    prover = P.BrainfuckStark(trace["processor"].shape[0],
                              trace["memory"].shape[0], program, "", "",
                              P.StarkConfig(), device="cpu")
    assert [t.height for t in prover.tables] == mix["heights"]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_draws_stay_in_the_bucket(mix, seed):
    stream = generator.JobStream(mix, seed)
    jobs = [stream.next() for _ in range(40)]
    ks = [j.values["k"] for j in jobs]
    assert all(stream.lo <= k <= stream.hi for k in ks)
    # antithetic pairs: each pair sums to lo + hi
    assert all(a + b == stream.lo + stream.hi
               for a, b in zip(ks[0::2], ks[1::2]))
    assert len({j.seed for j in jobs}) == len(jobs)
    again = generator.JobStream(mix, seed)
    assert [again.next() for _ in range(40)] == jobs
    other = generator.JobStream(mix, seed, stream=1)
    assert [other.next().seed for _ in range(4)] != [j.seed for j in jobs[:4]]


def test_given_bounds_skip_the_search(mix, monkeypatch):
    """A run finds the range once and hands it to each of its streams."""
    bounds = generator.drawn_range(mix)
    calls = []
    monkeypatch.setattr(generator, "parameter_range",
                        lambda *a: calls.append(a) or bounds)
    a = generator.JobStream(mix, 2**31 + 11, 0, bounds)
    b = generator.JobStream(mix, 2**31 + 11)
    assert calls == [(mix, "k")]
    assert [a.next() for _ in range(6)] == [b.next() for _ in range(6)]
