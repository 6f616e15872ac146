"""AIR constraint interpreters.

Each table's constraints are written once as plain python functions over an
abstract algebra `A` (const/one/zero) and operands with `+ - *` (and `**`
by a python int). Three interpreters run them:

  - `SymbolicAlgebra` — operands are `SymExpr` sparse polynomials, for the
    degree bounds;
  - `ArrayAlgebra` — operands wrap int64 tensors (base `(N,)` or extension
    `(N, 3)`), so the constraint function is the row evaluator vectorised
    over a whole codeword (prover, on the device) or over the query points
    (verifier, on the CPU);
  - `ProgramAlgebra` — operands are nodes of a straight-line `Program`, one
    table's quotients at one row: what kernel F4 evaluates
    (`ops/quotient_kernels.py` emits it as C++), and `run_plain` evaluates
    on the plain field operations.

`Table.quotients` ends each constraint with `alg.quotient(c, zinv)`, the
constraint times a zerofier inverse, so that all three see one output
order: boundary, transition, terminal.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple, Union

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


# ---------------------------------------------------------------------------
# straight-line programs of one table's quotients
# ---------------------------------------------------------------------------

ZEROFIERS = ("boundary", "transition", "terminal")


class Program:
    """One table's quotients at one row, as a straight-line SSA program.

    `ops[k]` is node k, a tuple whose first item names the operation:

      ("base", c, nxt)   base column c at the row (nxt 0) or the next (1)
      ("ext", c, nxt)    extension column c (counted from the first
                         extension column), likewise
      ("ch", k)          challenge k (extension)
      ("tm", k)          terminal k (extension)
      ("const", v)       a constant: an int (base) or a 3-tuple (extension)
      ("add", a, b), ("sub", a, b), ("mul", a, b), ("neg", a)
      ("pow", a, s)      a to the runtime exponent params[s]

    on earlier nodes a, b; `ext[k]` says whether node k is an extension
    value, by `AVal._promote`'s rule (an operation is extension if an
    operand is). `outputs` lists (node, zerofier kind) in the order of
    `Table.quotients`: each output is the node times that kind's zerofier
    inverse. The challenges and terminals are runtime inputs, and so are
    the exponents `params` (the IO tables raise a challenge to height -
    length): the rest, and so `key`, is fixed per table class."""

    def __init__(self, base_width: int, ext_width: int):
        self.base_width = base_width
        self.ext_width = ext_width
        self.ops: List[tuple] = []
        self.ext: List[bool] = []
        self.outputs: List[Tuple[int, str]] = []
        self.params: List[int] = []

    def add(self, op: tuple, ext: bool) -> int:
        self.ops.append(op)
        self.ext.append(ext)
        return len(self.ops) - 1

    @property
    def key(self) -> int:
        """64 bits of a hash of the program's structure (its ops, types,
        outputs and widths, not the exponents' values)."""
        h = hashlib.blake2b(digest_size=8)
        h.update(repr((self.base_width, self.ext_width, self.ops, self.ext,
                       self.outputs, len(self.params))).encode())
        return int.from_bytes(h.digest(), "big")


class PVal:
    """A program node as an operand of the constraint functions."""

    __slots__ = ("prog", "node", "ext")

    def __init__(self, prog: Program, node: int, ext: bool):
        self.prog = prog
        self.node = node
        self.ext = ext

    def _op(self, name: str, other: "PVal") -> "PVal":
        ext = self.ext or other.ext
        return PVal(self.prog,
                    self.prog.add((name, self.node, other.node), ext), ext)

    def __add__(self, other: "PVal") -> "PVal":
        return self._op("add", other)

    def __sub__(self, other: "PVal") -> "PVal":
        return self._op("sub", other)

    def __mul__(self, other: "PVal") -> "PVal":
        return self._op("mul", other)

    def __neg__(self) -> "PVal":
        return PVal(self.prog, self.prog.add(("neg", self.node), self.ext),
                    self.ext)

    def __pow__(self, e: int) -> "PVal":
        self.prog.params.append(int(e))
        slot = len(self.prog.params) - 1
        return PVal(self.prog, self.prog.add(("pow", self.node, slot),
                                             self.ext), self.ext)


class ProgramAlgebra:
    """Records a table's quotients as a `Program` (`record`)."""

    def __init__(self, base_width: int, ext_width: int):
        self.program = Program(base_width, ext_width)

    def _leaf(self, op: tuple, ext: bool) -> PVal:
        return PVal(self.program, self.program.add(op, ext), ext)

    def const(self, c: Union[int, tuple]) -> PVal:
        if isinstance(c, tuple):
            return self._leaf(("const", tuple(int(x) % f.P for x in c)),
                              True)
        return self._leaf(("const", int(c) % f.P), False)

    def zero(self) -> PVal:
        return self.const(0)

    def one(self) -> PVal:
        return self.const(1)

    def quotient(self, c: PVal, kind: str) -> int:
        self.program.outputs.append((c.node, kind))
        return len(self.program.outputs) - 1

    @classmethod
    def record(cls, table) -> Program:
        """The program of `table.quotients`: its columns at the row and
        the next, the 11 challenges and 5 terminals as inputs, and each
        zerofier inverse named by its kind."""
        alg = cls(table.base_width, table.num_ext_columns)
        rows = []
        for nxt in (0, 1):
            rows.append(
                [alg._leaf(("base", c, nxt), False)
                 for c in range(table.base_width)]
                + [alg._leaf(("ext", c, nxt), True)
                   for c in range(table.num_ext_columns)])
        challenges = [alg._leaf(("ch", k), True) for k in range(11)]
        terminals = [alg._leaf(("tm", k), True) for k in range(5)]
        table.quotients(alg, rows[0], rows[1], challenges, terminals,
                        {kind: kind for kind in ZEROFIERS})
        return alg.program


def run_plain(program: Program, base_cw, ext_cw, base_next, ext_next,
              challenges, terminals, zinv: Dict[str, object],
              params: Sequence[int] = None):
    """The program over whole columns on the plain field operations
    (`field.add_plain`, ..., `xfield.mul_plain`): base_cw (width, n) and
    ext_cw (n_ext, n, 3) at the row, base_next and ext_next at the next
    row, challenges (11, 3), terminals (5, 3), zinv {kind: (n,) or 0-dim}.
    Returns the (T, n, 3) stack of `Table.quotients`."""
    params = program.params if params is None else params
    device = base_cw.device

    def lift(v, ext):
        return v if ext else xf.from_base(v)

    vals: List[object] = []
    for op, ext in zip(program.ops, program.ext):
        kind = op[0]
        if kind == "base":
            v = (base_next if op[2] else base_cw)[op[1]]
        elif kind == "ext":
            v = (ext_next if op[2] else ext_cw)[op[1]]
        elif kind == "ch":
            v = challenges[op[1]]
        elif kind == "tm":
            v = terminals[op[1]]
        elif kind == "const":
            v = (xf.scalar(*op[1], device=device) if ext else
                 torch.tensor(to_i64(op[1]), dtype=torch.int64,
                              device=device))
        elif kind == "neg":
            v = f.neg(vals[op[1]])
        elif kind == "pow":
            v = _pow_plain(vals[op[1]], params[op[2]], ext)
        else:
            a, b = vals[op[1]], vals[op[2]]
            ea, eb = program.ext[op[1]], program.ext[op[2]]
            if kind == "mul":
                if ea and eb:
                    v = xf.mul_plain(a, b)
                elif ea or eb:
                    v = xf.mul_base_plain(a if ea else b, b if ea else a)
                else:
                    v = f.mul_plain(a, b)
            else:
                fn = f.add_plain if kind == "add" else f.sub_plain
                v = fn(lift(a, ea or not ext), lift(b, eb or not ext))
        vals.append(v)
    out = [xf.mul_base_plain(lift(vals[node], program.ext[node]), zinv[kind])
           for node, kind in program.outputs]
    n = base_cw.shape[1]
    return torch.stack([q.expand(n, 3) for q in out], dim=0)


def _pow_plain(a, e: int, ext: bool):
    """`pow_const` on the plain multiplies."""
    if e == 0:
        return (xf.ones(a.shape[:-1], a.device) if ext
                else torch.ones_like(a))
    mul = xf.mul_plain if ext else f.mul_plain
    acc = None
    for bit in bin(e)[2:]:
        if acc is not None:
            acc = mul(acc, acc)
        if bit == "1":
            acc = a if acc is None else mul(acc, a)
    return acc


def dispatches(program: Program, params: Sequence[int] = None) -> dict:
    """The field operations `ArrayAlgebra` dispatches for the program, by
    kind: F1 ("add", "sub", "mul": base-field calls, an extension add or
    sub being one call over the coefficient words), F2 ("xmul",
    "xmul_base") and the two that are no kernel ("neg", a torch.where, and
    "from_base", a torch.cat that lifts a base operand)."""
    params = program.params if params is None else params
    out = dict.fromkeys(("add", "sub", "mul", "xmul", "xmul_base", "neg",
                         "from_base"), 0)
    for op, ext in zip(program.ops, program.ext):
        kind = op[0]
        if kind in ("add", "sub", "mul"):
            ea, eb = program.ext[op[1]], program.ext[op[2]]
            if kind == "mul":
                key = "xmul" if ea and eb else "xmul_base" if ext else "mul"
                out[key] += 1
            else:
                out[kind] += 1
                out["from_base"] += ea != eb
        elif kind == "neg":
            out["neg"] += 1
        elif kind == "pow":
            e = params[op[2]]
            if e:
                out["xmul" if ext else "mul"] += (
                    e.bit_length() - 1 + bin(e).count("1") - 1)
    for node, _ in program.outputs:
        out["xmul_base"] += 1
        out["from_base"] += not program.ext[node]
    return out
