"""The port's host polynomial layer (`ops/poly.py`) element for element
against the JAX package's, on the inputs of tests/test_poly.py (the same
seeded draws), and the DEBUG degree checks (`debug_degree_checks`) of the
port's prover against the JAX package's. Tolerance: none, the integers and
the proof bytes must be equal."""

import os
import sys

import numpy as np
import pytest
import torch

import stark_brainfuck_tpu as J
import stark_brainfuck_tpu_torch as TP
from stark_brainfuck_tpu.ops import poly as jpl
from stark_brainfuck_tpu_torch.ops import field as f
from stark_brainfuck_tpu_torch.ops import poly as pl

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def _rng():
    return np.random.default_rng(31)


def rand_poly(rng, d):
    return [int(v) for v in rng.integers(0, f.P, d + 1, dtype=np.uint64)]


def test_divide_roundtrip():
    rng = _rng()
    a, b = rand_poly(rng, 7), rand_poly(rng, 3)
    q, r = pl.divide(a, b)
    assert (q, r) == jpl.divide(a, b)
    back = pl.add(pl.mul(q, b), r)
    assert back == jpl.add(jpl.mul(q, b), r)
    assert pl.trim(back) == pl.trim(a)
    assert pl.degree(r) < pl.degree(b)


def test_xgcd_bezout():
    rng = _rng()
    a, b = rand_poly(rng, 5), rand_poly(rng, 3)
    s, t, g = pl.xgcd(a, b)
    assert (s, t, g) == jpl.xgcd(a, b)
    lhs = pl.add(pl.mul(s, a), pl.mul(t, b))
    assert pl.trim(lhs) == pl.trim(g)


def test_interpolate_evaluate_roundtrip():
    rng = _rng()
    xs = [int(v) for v in rng.choice(np.arange(1, 1000), 8, replace=False)]
    ys = [int(v) for v in rng.integers(0, f.P, 8, dtype=np.uint64)]
    coeffs = pl.interpolate(xs, ys)
    assert coeffs == jpl.interpolate(xs, ys)
    assert pl.degree(coeffs) < 8
    assert pl.evaluate_domain(coeffs, xs) == ys == jpl.evaluate_domain(
        coeffs, xs)


def test_zerofier_vanishes():
    xs = [3, 17, 99]
    z = pl.zerofier(xs)
    assert z == jpl.zerofier(xs)
    assert pl.degree(z) == 3
    for x in xs:
        assert pl.evaluate(z, x) == 0


def test_colinearity():
    # y = 5x + 7
    pts = [(1, 12), (2, 17), (10, 57)]
    bad = [(1, 12), (2, 17), (10, 58)]
    assert pl.test_colinearity(pts) and jpl.test_colinearity(pts)
    assert not pl.test_colinearity(bad) and not jpl.test_colinearity(bad)


def test_small_helpers_match_jax():
    rng = _rng()
    a, b = rand_poly(rng, 6) + [0, 0], rand_poly(rng, 2)
    for name in ("degree", "trim", "neg"):
        assert getattr(pl, name)(a) == getattr(jpl, name)(a), name
    for name in ("add", "sub", "mul"):
        assert getattr(pl, name)(a, b) == getattr(jpl, name)(a, b), name
    assert pl.scalar_mul(a, 12345) == jpl.scalar_mul(a, 12345)
    assert pl.evaluate(a, 77) == jpl.evaluate(a, 77)
    assert pl.divide(b, a) == jpl.divide(b, a)  # deg num < deg den


# ---------------------------------------------------------------------------
# DEBUG degree checks
# ---------------------------------------------------------------------------


def _pair(src, inp="", seed=0, trace=None, **config):
    program = J.VirtualMachine.compile(src)
    tr = trace or J.VirtualMachine.simulate(program, inp)
    args = (tr["processor"], tr["memory"], tr["instruction"], tr["input"],
            tr["output"])

    def make(pkg, **kw):
        return pkg.BrainfuckStark(
            tr["processor"].shape[0], tr["memory"].shape[0], program, inp,
            tr.get("output_data", ""), pkg.StarkConfig(seed=seed, **config),
            **kw)

    return make(J), make(TP, device="cpu"), args


def test_debug_degree_checks_pass_on_honest_prove():
    """The mirror of tests/test_poly.py::test_debug_degree_checks_pass_on_
    honest_prove: with the checks on, the port proves, its proof verifies
    and equals the JAX package's and the port's own with the checks off."""
    jb, tb, args = _pair("+>[+<-]", debug_degree_checks=True)
    pt = tb.prove(*args)
    assert tb.config.debug_degree_checks
    assert tb.verify(pt), tb.last_rejection
    assert pt == jb.prove(*args, xp=np)
    _, off, _ = _pair("+>[+<-]", debug_degree_checks=False)
    assert off.prove(*args) == pt


def test_debug_degree_checks_follow_the_debug_variable(monkeypatch):
    monkeypatch.setenv("DEBUG", "1")
    assert TP.StarkConfig().debug_degree_checks
    assert J.StarkConfig().debug_degree_checks
    monkeypatch.delenv("DEBUG")
    assert not TP.StarkConfig().debug_degree_checks
    assert not J.StarkConfig().debug_degree_checks


@pytest.mark.parametrize("codec", ["native", "ref"])
def test_debug_degree_checks_refuse_the_forged_trace(codec):
    """Mallory's forged trace (tests/test_stark.py::test_mallory_forged_
    trace_rejected): with the checks on, both packages' provers raise on
    the quotient that does not divide cleanly."""
    sys.path.insert(0, HERE)
    from test_stark import mallory_simulate

    program = J.VirtualMachine.compile("+>[++<-]")
    forged = {**mallory_simulate(program), "output_data": ""}
    jb, tb, args = _pair("+>[++<-]", seed=3, trace=forged, codec=codec,
                         debug_degree_checks=True)
    with pytest.raises(AssertionError, match="processor quotient") as got:
        tb.prove(*args)
    with pytest.raises(AssertionError) as want:
        jb.prove(*args, xp=np)
    assert str(got.value) == str(want.value)
