"""The port's symbolic multivariate layer, test for test of
tests/test_symbolic.py (ref test_multivariate.py's degree-bound regressions
plus evaluate/partial_evaluate/lift). Every expression is built in both the
JAX package and the port, through the same steps; the two must agree term
for term and on every query, and the hand-derived values stay as a second
check."""

import numpy as np
import pytest

from stark_brainfuck_tpu.models import symbolic as jsym
from stark_brainfuck_tpu.ops import xfield as jxf
from stark_brainfuck_tpu_torch.models import symbolic as tsym
from stark_brainfuck_tpu_torch.ops import xfield as xf

PACKAGES = ((jsym.SymExpr, jxf), (tsym.SymExpr, xf))


def both(build):
    """Run `build(SymExpr, xfield)` in the JAX package and in the port and
    return the port's result after checking that the two are equal."""
    jres, tres = (build(S, x) for S, x in PACKAGES)
    assert _plain(tres) == _plain(jres)
    return tres


def _plain(v):
    """SymExprs as their term dicts, so the two packages' results compare."""
    if isinstance(v, (jsym.SymExpr, tsym.SymExpr)):
        return dict(v.d)
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(e) for e in v)
    return v


def test_degree_bound_skips_zero_coefficients():
    # (x0 - x0) has a stored zero-coefficient term; bound must ignore it
    def build(S, x):
        v = S.variables(2)
        z = v[0] - v[0]
        return z, z.is_zero(), z.symbolic_degree_bound([5, 5])

    _, is_zero, bound = both(build)
    assert is_zero and bound == -1


def test_degree_bound_sum_of_exponents():
    def build(S, x):
        v = S.variables(3)
        p = v[0] * v[0] * v[1] + v[2]
        return p, p.symbolic_degree_bound([4, 4, 4])

    # exponents (2,1,0) -> 3*md; (0,0,1) -> md
    assert both(build)[1] == 12


def test_degree_bound_cancellation():
    def build(S, x):
        v = S.variables(2)
        p = v[0] * v[1] + v[0] * v[1]
        q = p - v[0] * v[1] - v[0] * v[1]  # coefficients cancel to zero
        return q, q.symbolic_degree_bound([7, 7])

    assert both(build)[1] == -1


def test_evaluate_matches_reference_semantics():
    def build(S, x):
        v = S.variables(2)
        p = v[0] * v[0] + S.constant(3) * v[1] + S.constant(5)
        return p, p.evaluate([x.h_from_base(11), x.h_from_base(2)])

    assert both(build)[1] == xf.h_from_base(11 * 11 + 3 * 2 + 5)


def test_partial_evaluate():
    def build(S, x):
        v = S.variables(2)
        p = v[0] * v[1] + v[1]
        q = p.partial_evaluate({0: x.h_from_base(7)})
        return q, q.evaluate([x.h_from_base(0), x.h_from_base(3)])

    # q(y) = 7y + y = 8y
    assert both(build)[1] == xf.h_from_base(24)


def test_evaluate_symbolic_composition():
    def build(S, x):
        v = S.variables(1)
        p = v[0] * v[0] + S.constant(1)  # f(g) = g^2 + 1
        g = [x.h_from_base(1), x.h_from_base(2)]  # g(x) = 1 + 2x
        return p.evaluate_symbolic([g])

    # (1+2x)^2 + 1 = 2 + 4x + 4x^2
    assert both(build) == [xf.h_from_base(2), xf.h_from_base(4),
                           xf.h_from_base(4)]


def test_lift():
    def build(S, x):
        coeffs = [x.h_from_base(3), x.h_from_base(1)]  # 3 + x
        m = S.lift(coeffs, 2)  # in variable x2
        return m, m.evaluate([x.H_ZERO, x.H_ZERO, x.h_from_base(4)])

    assert both(build)[1] == xf.h_from_base(7)


@pytest.mark.parametrize("seed", range(4))
def test_random_expressions_match_jax(seed):
    """Seeded random sums of products of powers, with extension-field
    constants: the two packages agree on the terms, the degree bound, the
    evaluation, a partial evaluation, a composition with univariates, a
    power and a lift."""
    rng = np.random.default_rng(seed)
    nv = 3

    def scalar():
        return tuple(int(c) for c in rng.integers(0, xf.P, 3, dtype=np.uint64))

    consts = [scalar() for _ in range(6)]
    picks = [(int(rng.integers(nv)), int(rng.integers(nv)),
              int(rng.integers(1, 3))) for _ in range(6)]
    point = [scalar() for _ in range(nv)]
    polys = [[scalar() for _ in range(int(rng.integers(1, 4)))]
             for _ in range(nv)]

    def build(S, x):
        v = S.variables(nv)
        p = S.zero()
        for c, (i, j, e) in zip(consts, picks):
            p = p + S.constant(c) * v[i] * (v[j] ** e)
        q = p - v[0] * v[1]
        return (p, q, q.is_zero(), q.symbolic_degree_bound([3, 5, 7]),
                q.evaluate(point), q.partial_evaluate({1: point[1]}),
                q.evaluate_symbolic(polys), q ** 2,
                S.lift(polys[0], nv - 1))

    both(build)
