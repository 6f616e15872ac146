"""The one traffic generator: jobs drawn from a traffic mix's data file.

A mix (`traffic/<name>.json`) names a Brainfuck program as a list of parts,
each a piece of source and how many times it repeats: a number, or the name
of a parameter drawn per job. A parameter's draw gives the range of the
job's cost, its running time plus its program length: the parameter takes
every value whose cost lies in [cost_from, cost_below), found by bisection
with the reference's interpreter (the cost rises with the parameter). The
mix also gives the program's input and the table heights every job must
pad to, so that every job does the same work.

Jobs come in antithetic pairs: a value drawn uniformly from the range, then
its mirror image in it. Each value is uniform over the range, and a pair's
mean cycle count does not depend on the seed (a counter's running time is
affine in its count), so a window's mean work per job varies little from
seed to seed. Each job also draws its own prover seed, so that no two
proofs are equal and no cache of traces or proofs can stand in for the
work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from reference.bfstark.vm.machine import VirtualMachine

# prover seeds are drawn below this
SEED_SPACE = 1 << 62


@dataclass(frozen=True)
class JobSpec:
    index: int
    source: str
    input: str
    values: Dict[str, int]
    seed: int


def program_source(parts: List[list], values: Dict[str, int]) -> str:
    """The program's source: each part's text repeated as often as its
    count, a number or the value of the named parameter."""
    out = []
    for text, count in parts:
        n = values[count] if isinstance(count, str) else int(count)
        out.append(text * n)
    return "".join(out)


def cost(source: str, input_data: str) -> int:
    """Running time plus program length, as the reference runs it."""
    program = VirtualMachine.compile(source)
    running_time, _, _ = VirtualMachine.run(program, input_data)
    return running_time + len(program)


def parameter_range(traffic: dict, name: str) -> Tuple[int, int]:
    """(lo, hi), inclusive: the values of parameter `name` whose job cost
    lies in [cost_from, cost_below), the other parameters absent."""
    draw = traffic["draw"][name]
    parts, input_data = traffic["program"], traffic.get("input", "")

    def c(v):
        return cost(program_source(parts, {name: v}), input_data)

    def first_at_least(bound):
        lo, hi = 0, 1
        while c(hi) < bound:
            lo, hi = hi, hi * 2
        while lo + 1 < hi:  # c(lo) < bound <= c(hi)
            mid = (lo + hi) // 2
            if c(mid) < bound:
                lo = mid
            else:
                hi = mid
        return hi

    lo = first_at_least(draw["cost_from"])
    hi = first_at_least(draw["cost_below"]) - 1
    if hi < lo:
        raise ValueError(f"no value of {name} gives a cost in "
                         f"[{draw['cost_from']}, {draw['cost_below']})")
    return lo, hi


def drawn_range(traffic: dict) -> Tuple[int, int]:
    """The range of the mix's one drawn parameter (`parameter_range`)."""
    if len(traffic["draw"]) != 1:
        raise ValueError("a mix draws one parameter")
    return parameter_range(traffic, next(iter(traffic["draw"])))


class JobStream:
    """The jobs of one run, in order, from its seed; `stream` tells apart
    the independent streams of one seed (the warm-up's, the window's), and
    `bounds`, where given, is the mix's `drawn_range`, found once a run."""

    def __init__(self, traffic: dict, seed: int, stream: int = 0,
                 bounds: Optional[Tuple[int, int]] = None):
        self.traffic = traffic
        self.lo, self.hi = drawn_range(traffic) if bounds is None else bounds
        self.name = next(iter(traffic["draw"]))
        s = seed % (1 << 128)
        self._rng = np.random.default_rng([s & ((1 << 64) - 1), s >> 64,
                                           stream])
        self._pending = None
        self._count = 0

    def _value(self) -> int:
        if self._pending is not None:
            v, self._pending = self._pending, None
            return v
        v = int(self._rng.integers(self.lo, self.hi + 1))
        self._pending = self.lo + self.hi - v
        return v

    def next(self) -> JobSpec:
        values = {self.name: self._value()}
        spec = JobSpec(
            index=self._count,
            source=program_source(self.traffic["program"], values),
            input=self.traffic.get("input", ""),
            values=values,
            seed=int(self._rng.integers(0, SEED_SPACE)),
        )
        self._count += 1
        return spec
