"""AIR constraint interpreters.

Each table's constraints are written once as plain python functions over an
abstract algebra `A` (const/one/zero) and operands with `+ - *` (and `**`
by a python int). Two interpreters run them:

  - `SymbolicAlgebra` — operands are `SymExpr` sparse polynomials, for the
    degree bounds;
  - `ArrayAlgebra` — operands wrap int64 tensors (base `(N,)` or extension
    `(N, 3)`), so the constraint function is the row evaluator vectorised
    over a whole codeword.

`Table.quotients` ends each constraint with `alg.quotient(c, zinv)`, the
constraint times a zerofier inverse, in one output order: boundary,
transition, terminal.
"""

from __future__ import annotations

from typing import List, Union

import torch

from ..convert import to_i64
from ..ops import field as f
from ..ops import xfield as xf
from .symbolic import SymExpr


class SymbolicAlgebra:
    """Builds SymExpr operands; mirrors MPolynomial.variables/constant."""

    def __init__(self, num_variables: int):
        self.num_variables = num_variables

    def variables(self) -> List[SymExpr]:
        return SymExpr.variables(self.num_variables)

    def const(self, c) -> SymExpr:
        return SymExpr.constant(c, 1)

    def zero(self) -> SymExpr:
        return SymExpr.zero()

    def one(self) -> SymExpr:
        return SymExpr.constant(1, 1)


class AVal:
    """A tensor-backed field value: base ((...,)) or extension ((..., 3))."""

    __slots__ = ("arr", "ext", "alg")

    def __init__(self, arr, ext: bool, alg: "ArrayAlgebra"):
        self.arr = arr
        self.ext = ext
        self.alg = alg

    def _promote(self, other: "AVal"):
        a, b = self, other
        if a.ext == b.ext:
            return a.arr, b.arr, a.ext
        if a.ext:
            return a.arr, xf.from_base(b.arr), True
        return xf.from_base(a.arr), b.arr, True

    def __add__(self, other: "AVal") -> "AVal":
        a, b, ext = self._promote(other)
        return AVal(f.add(a, b), ext, self.alg)

    def __sub__(self, other: "AVal") -> "AVal":
        a, b, ext = self._promote(other)
        return AVal(f.sub(a, b), ext, self.alg)

    def __neg__(self) -> "AVal":
        return AVal(f.neg(self.arr), self.ext, self.alg)

    def __mul__(self, other: "AVal") -> "AVal":
        if self.ext and other.ext:
            return AVal(xf.mul(self.arr, other.arr), True, self.alg)
        if self.ext != other.ext:
            e = self if self.ext else other
            b = other if self.ext else self
            return AVal(xf.mul_base(e.arr, b.arr), True, self.alg)
        return AVal(f.mul(self.arr, other.arr), False, self.alg)

    def __pow__(self, e: int) -> "AVal":
        if self.ext:
            return AVal(xf.pow_const(self.arr, e), True, self.alg)
        return AVal(f.pow_const(self.arr, e), False, self.alg)


class ArrayAlgebra:
    """Vectorised constraint evaluation over int64 tensors on `device`."""

    def __init__(self, device=None):
        self.device = device

    def base(self, arr) -> AVal:
        return AVal(arr, False, self)

    def x(self, arr) -> AVal:
        return AVal(arr, True, self)

    def const(self, c: Union[int, tuple]) -> AVal:
        if isinstance(c, tuple):
            return AVal(xf.scalar(*c, device=self.device), True, self)
        return AVal(
            torch.tensor(to_i64(c % f.P), dtype=torch.int64,
                         device=self.device),
            False, self,
        )

    def zero(self) -> AVal:
        return self.const(0)

    def one(self) -> AVal:
        return self.const(1)

    @staticmethod
    def to_ext(v: AVal):
        """The (..., 3) extension tensor of a value."""
        if v.ext:
            return v.arr
        return xf.from_base(v.arr)

    @staticmethod
    def quotient(c: AVal, zinv):
        """A constraint's quotient codeword: c times the base-field
        zerofier inverse `zinv`, as an extension tensor."""
        return xf.mul_base(ArrayAlgebra.to_ext(c), zinv)
