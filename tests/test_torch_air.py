"""Torch port AIR tables vs the JAX package's tables on a traced program:
extension columns, terminals, quotients and degree bounds, exact."""

import numpy as np
import pytest
import torch

from stark_brainfuck_tpu import VirtualMachine as JVM
from stark_brainfuck_tpu.models import instruction as jins
from stark_brainfuck_tpu.models import io as jio
from stark_brainfuck_tpu.models import memory as jmem
from stark_brainfuck_tpu.models import processor as jproc
from stark_brainfuck_tpu.models.interp import ArrayAlgebra as JAlg
from stark_brainfuck_tpu_torch import VirtualMachine as TVM
from stark_brainfuck_tpu_torch.convert import tensor_to_u64 as U
from stark_brainfuck_tpu_torch.convert import u64_to_tensor as T
from stark_brainfuck_tpu_torch.models import instruction as tins
from stark_brainfuck_tpu_torch.models import io as tio
from stark_brainfuck_tpu_torch.models import memory as tmem
from stark_brainfuck_tpu_torch.models import processor as tproc
from stark_brainfuck_tpu_torch.models.interp import ArrayAlgebra as TAlg

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001
SRC, INP = ",[->+<]>.+.", "\x05"

# (JAX class, port class, trace key, constructor length)
TABLES = {
    "processor": (jproc.ProcessorTable, tproc.ProcessorTable, "processor"),
    "instruction": (jins.InstructionTable, tins.InstructionTable, "instruction"),
    "memory": (jmem.MemoryTable, tmem.MemoryTable, "memory"),
    "input": (jio.InputTable, tio.InputTable, "input"),
    "output": (jio.OutputTable, tio.OutputTable, "output"),
}


@pytest.fixture(scope="module")
def trace():
    program = JVM.compile(SRC)
    assert TVM.compile(SRC) == program
    tr = JVM.simulate(program, INP, native=False)
    tr_port = TVM.simulate(program, INP)
    for k in ("processor", "memory", "instruction", "input", "output"):
        assert np.array_equal(tr[k], tr_port[k]), k
    return program, tr


def _make(name, program, tr):
    jcls, tcls, key = TABLES[name]
    rows = tr[key].shape[0]
    if name in ("input", "output"):
        args = (rows,)
    elif name == "instruction":
        args = (tr["processor"].shape[0] + len(program), 1)
    else:
        args = (rows, 1)
    tables = []
    for cls in (jcls, tcls):
        t = cls(*args)
        t.matrix = np.asarray(tr[key], dtype=np.uint64).reshape(-1, t.base_width)
        if len(t.matrix):
            t.pad()
        tables.append(t)
    return tables


def _counter_rows(k, key):
    """One table of the benchmark traffic's two-level counter program at
    outer count k; k = 239 and 317 are the ends of its range, where cycles
    plus program length lie in [3/4 · 2^15, 2^15)."""
    tr = TVM.simulate(TVM.compile("+" * k + "[->" + "+" * 32 + "[-]<]"), "")
    return tr[key]


def _random_rows(name, rows, last_clk=None):
    width = TABLES[name][1].base_width
    m = np.random.default_rng(rows).integers(0, P, (rows, width), dtype=np.uint64)
    if last_clk is not None:
        m[-1, 0] = last_clk  # clk is column 0 of the processor and memory
    return m


PAD_CASES = [
    (name, rows, None)
    for name in ("processor", "instruction", "memory")
    for rows in (1, 2, 3, 1023, 1024, 1025, "counter-239", "counter-317")
] + [("processor", 5, P - 3), ("memory", 13, P - 3)]


@pytest.mark.parametrize("name,rows,last_clk", PAD_CASES)
def test_pad_matches_jax(name, rows, last_clk):
    if isinstance(rows, str):
        m = _counter_rows(int(rows.split("-")[1]), TABLES[name][2])
    else:
        m = _random_rows(name, rows, last_clk)
    jcls, tcls, _ = TABLES[name]
    jt, tt = jcls(len(m), 1), tcls(len(m), 1)
    jt.matrix, tt.matrix = m.copy(), m.copy()
    jt.pad()
    tt.pad()
    want = np.asarray(jt.matrix)
    assert tt.matrix.shape == want.shape
    assert tt.matrix.dtype == np.uint64
    assert tt.matrix.flags["C_CONTIGUOUS"]
    assert tt.height == jt.height == want.shape[0]
    assert np.array_equal(tt.matrix, want)
    if last_clk is not None:
        assert 0 in tt.matrix[:, 0]  # the clock wrapped past p - 1


def _xvals(rng, n):
    return [tuple(int(v) for v in rng.integers(0, P, 3, dtype=np.uint64))
            for _ in range(n)]


@pytest.mark.parametrize("name", list(TABLES))
def test_extension_columns_and_terminals_match(trace, name):
    program, tr = trace
    jt, tt = _make(name, program, tr)
    rng = np.random.default_rng(1)
    ch, ini = _xvals(rng, 11), _xvals(rng, 2)
    jcols = np.asarray(jt.extend(ch, ini, np))
    cols, terms = tt.extend_pure(T(tt.matrix), T(ch), T(ini))
    assert np.array_equal(jcols, U(cols).reshape(jcols.shape))
    got_terms = {
        n: tuple(int(v) for v in U(terms)[j])
        for j, n in enumerate(tt.terminal_names)
    }
    assert got_terms == jt.terminals


@pytest.mark.parametrize("name", list(TABLES))
def test_quotients_and_degree_bounds_match(trace, name):
    program, tr = trace
    jt, tt = _make(name, program, tr)
    rng = np.random.default_rng(2)
    L = 64
    base = rng.integers(0, P, size=(jt.base_width, L), dtype=np.uint64)
    ext = rng.integers(0, P, size=(jt.num_ext_columns, L, 3), dtype=np.uint64)
    zinv = {k: rng.integers(0, P, size=L, dtype=np.uint64)
            for k in ("boundary", "transition", "terminal")}
    ch, tm = _xvals(rng, 11), _xvals(rng, 5)
    ja, ta = JAlg(np), TAlg("cpu")

    def points(alg, conv, shift):
        p = [alg.base(conv(np.roll(base[j], -shift))) for j in range(len(base))]
        return p + [alg.x(conv(np.roll(ext[j], -shift, axis=0)))
                    for j in range(len(ext))]

    def args(alg, conv):
        return (
            alg, points(alg, conv, 0), points(alg, conv, 3),
            [alg.x(conv(np.asarray(c, dtype=np.uint64))) for c in ch],
            [alg.x(conv(np.asarray(t, dtype=np.uint64))) for t in tm],
            {k: conv(v) for k, v in zinv.items()},
        )

    want = jt.quotients(*args(ja, lambda a: a))
    got = tt.quotients(*args(ta, T))
    assert len(want) == len(got) > 0
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), U(g))
    assert jt.all_quotient_degree_bounds(ch, tm) == tt.all_quotient_degree_bounds(ch, tm)
    ones = [(1, 0, 0)] * 11
    jb = [c.symbolic_degree_bound([jt.interpolant_degree()] * (2 * jt.full_width))
          for c in jt.symbolic_transition_constraints(ones)]
    tb = [c.symbolic_degree_bound([tt.interpolant_degree()] * (2 * tt.full_width))
          for c in tt.symbolic_transition_constraints(ones)]
    assert jb == tb
