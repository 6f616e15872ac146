"""Sparse symbolic multivariate polynomials over F_{p^3} for degree
bookkeeping.

The symbolic form of the AIR constraints serves `symbolic_degree_bound`
(ref `multivariate.py:142-168`), which sets the FRI domain size and every
degree-shift exponent in the nonlinear combination; the constraints are
evaluated on codewords by `interp.ArrayAlgebra` instead. A copy of the JAX
package's `models/symbolic.py`. Its host-side evaluation helpers
(`evaluate`, `partial_evaluate`, `evaluate_symbolic`, `lift`, `is_zero`)
keep the JAX package's API; no prover path calls them, and
`tests/test_torch_symbolic.py` holds each to the JAX package's.

Coefficients are host-side 3-tuples of python ints (extension field scalars,
base elements embedded as (v, 0, 0)); cancellation behavior — which terms
survive with zero coefficients — must match the reference exactly, since the
reference's degree sweep at `brainfuck_stark.py:85-97` feeds challenges of
all-ones into the constraint builders and relies on the resulting
cancellations.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..ops import xfield as xf

Coeff = Tuple[int, int, int]


class SymExpr:
    """Sparse multivariate polynomial: {exponent tuple: xfield coeff}."""

    __slots__ = ("d",)

    def __init__(self, d: Dict[Tuple[int, ...], Coeff]):
        self.d = d

    # -- constructors -------------------------------------------------------

    @staticmethod
    def zero() -> "SymExpr":
        return SymExpr({})

    @staticmethod
    def constant(c, num_variables: int = 1) -> "SymExpr":
        if isinstance(c, int):
            c = xf.h_from_base(c)
        return SymExpr({(0,) * num_variables: c})

    @staticmethod
    def variables(n: int) -> List["SymExpr"]:
        out = []
        for i in range(n):
            exp = tuple(1 if j == i else 0 for j in range(n))
            out.append(SymExpr({exp: xf.H_ONE}))
        return out

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _pad(k: Tuple[int, ...], n: int) -> Tuple[int, ...]:
        return k if len(k) == n else k + (0,) * (n - len(k))

    def _num_vars_with(self, other: "SymExpr") -> int:
        ks = list(self.d.keys()) + list(other.d.keys())
        return max([0] + [len(k) for k in ks])

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other: "SymExpr") -> "SymExpr":
        n = self._num_vars_with(other)
        d: Dict[Tuple[int, ...], Coeff] = {}
        for k, v in self.d.items():
            d[self._pad(k, n)] = v
        for k, v in other.d.items():
            kk = self._pad(k, n)
            d[kk] = xf.h_add(d[kk], v) if kk in d else v
        return SymExpr(d)

    def __neg__(self) -> "SymExpr":
        return SymExpr({k: xf.h_neg(v) for k, v in self.d.items()})

    def __sub__(self, other: "SymExpr") -> "SymExpr":
        return self + (-other)

    def __mul__(self, other: "SymExpr") -> "SymExpr":
        if not self.d or not other.d:
            return SymExpr({})
        n = self._num_vars_with(other)
        d: Dict[Tuple[int, ...], Coeff] = {}
        for k0, v0 in self.d.items():
            for k1, v1 in other.d.items():
                exp = list(self._pad(k0, n))
                for i, e in enumerate(k1):
                    exp[i] += e
                key = tuple(exp)
                prod = xf.h_mul(v0, v1)
                d[key] = xf.h_add(d[key], prod) if key in d else prod
        return SymExpr(d)

    def __pow__(self, e: int) -> "SymExpr":
        if not self.d:
            return SymExpr({})
        n = len(next(iter(self.d.keys())))
        acc = SymExpr({(0,) * n: xf.H_ONE})
        for bit in bin(e)[2:]:
            acc = acc * acc
            if bit == "1":
                acc = acc * self
        return acc

    # -- queries ------------------------------------------------------------

    def is_zero(self) -> bool:
        return all(v == xf.H_ZERO for v in self.d.values())

    def degree(self) -> int:
        if not self.d:
            return -1
        return max(sum(k) for k in self.d.keys())

    def symbolic_degree_bound(self, max_degrees: List[int]) -> int:
        """Smallest degree bound on the univariate composition with
        polynomials of the given degrees; zero-coefficient terms are skipped
        (matches ref multivariate.py:142-168)."""
        if self.degree() == -1:
            return -1
        bound = -1
        for exps, coeff in self.d.items():
            if coeff == xf.H_ZERO:
                continue
            bound = max(bound, sum(e * md for e, md in zip(exps, max_degrees)))
        return bound

    def evaluate(self, point: List[Coeff]) -> Coeff:
        """Host-side exact evaluation (used in tests/oracle checks)."""
        acc = xf.H_ZERO
        for k, v in self.d.items():
            prod = v
            for i, e in enumerate(k):
                if e:
                    prod = xf.h_mul(prod, xf.h_pow(point[i], e))
            acc = xf.h_add(acc, prod)
        return acc

    def partial_evaluate(self, assignment: Dict[int, Coeff]) -> "SymExpr":
        """Substitute constants for some variables (ref
        multivariate.py:185-201)."""
        out = SymExpr({})
        for k, v in self.d.items():
            coeff = v
            exps = list(k)
            for i, e in enumerate(k):
                if i in assignment and e:
                    coeff = xf.h_mul(coeff, xf.h_pow(assignment[i], e))
                    exps[i] = 0
            term = SymExpr({tuple(exps): coeff})
            out = out + term
        return out

    def evaluate_symbolic(self, point: List[List[Coeff]]) -> List[Coeff]:
        """Compose with univariate polynomials (coefficient lists of
        extension scalars): returns the coefficients of the resulting
        univariate polynomial (ref multivariate.py:118-140)."""

        def pmul(a, b):
            if not a or not b:
                return []
            out = [xf.H_ZERO] * (len(a) + len(b) - 1)
            for i, ca in enumerate(a):
                for j, cb in enumerate(b):
                    out[i + j] = xf.h_add(out[i + j], xf.h_mul(ca, cb))
            return out

        def padd(a, b):
            n = max(len(a), len(b))
            return [
                xf.h_add(
                    a[i] if i < len(a) else xf.H_ZERO,
                    b[i] if i < len(b) else xf.H_ZERO,
                )
                for i in range(n)
            ]

        acc: List[Coeff] = []
        for k, v in self.d.items():
            prod = [v]
            for i, e in enumerate(k):
                for _ in range(e):
                    prod = pmul(prod, point[i])
            acc = padd(acc, prod)
        while acc and acc[-1] == xf.H_ZERO:
            acc.pop()
        return acc

    @staticmethod
    def lift(coeffs: List[Coeff], variable_index: int) -> "SymExpr":
        """Embed a univariate polynomial as a multivariate one in variable
        `variable_index` (ref multivariate.py:170-180)."""
        n = variable_index + 1
        d = {}
        for i, c in enumerate(coeffs):
            exp = [0] * n
            exp[variable_index] = i
            d[tuple(exp)] = c
        return SymExpr(d)
