"""Sparse symbolic multivariate polynomials over F_{p^3} for degree
bookkeeping.

The symbolic form of the AIR constraints serves `symbolic_degree_bound`
(ref `multivariate.py:142-168`), which sets the FRI domain size and every
degree-shift exponent in the nonlinear combination; the constraints are
evaluated on codewords by `interp.ArrayAlgebra` instead. A copy of the JAX
package's `models/symbolic.py` without its evaluation helpers.

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
