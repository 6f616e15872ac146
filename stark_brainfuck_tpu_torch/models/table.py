"""Abstract AIR trace table.

The JAX package's `models/table.py` on torch:

  - the trace matrix is a host u64 array, moved to the device as an int64
    tensor by the prover;
  - AIR constraints are single-source builder methods over an abstract
    algebra (see `interp.py`): instantiated symbolically for degree bounds
    and as vectorised evaluators for codeword-wide quotients;
  - quotient evaluation is a whole-codeword map: constraint evaluator ×
    precomputed zerofier-inverse tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..ops import field as f
from ..ops import scan as sc
from .interp import SymbolicAlgebra
from .symbolic import SymExpr


def roundup_npo2(n: int) -> int:
    """Next power of two; 0 stays 0 (ref table.py:22-28)."""
    if n == 0:
        return 0
    if n == 1:
        return 1
    return 1 << (n - 1).bit_length()


def clock_after(last, n: int) -> np.ndarray:
    """last + 1, ..., last + n mod p as a u64 column. For last < p and
    n < 2^32 no sum reaches 2^64, so one conditional subtraction of p is the
    whole reduction."""
    clk = np.arange(1, n + 1, dtype=np.uint64) + np.uint64(last)
    np.subtract(clk, np.uint64(f.P), out=clk, where=clk >= np.uint64(f.P))
    return clk


def derive_omicron(height: int) -> int:
    """Generator of the order-`height` subgroup; 1 for heights 0/1 (matches
    ref table.py:30-35, where squaring past order 1 also lands on 1)."""
    if height <= 1:
        return 1
    return f.primitive_nth_root(height)


class Table:
    name: str = "table"
    base_width: int = 0
    full_width: int = 0

    def __init__(self, length: int, num_randomizers: int):
        self.length = length
        self.num_randomizers = num_randomizers
        self.height = roundup_npo2(length)
        self.omicron = derive_omicron(self.height)
        self.matrix: Optional[np.ndarray] = None  # (rows, base_width) u64

    # -- geometry -----------------------------------------------------------

    @property
    def num_ext_columns(self) -> int:
        return self.full_width - self.base_width

    def unit_distance(self, omega_order: int) -> int:
        return 0 if self.height == 0 else omega_order // self.height

    def interpolation_domain_length(self) -> int:
        return self.height + self.num_randomizers

    def interpolant_degree(self) -> int:
        return self.interpolation_domain_length() - 1

    # -- constraint builders (override in subclasses) -----------------------
    # v: operand list; A: algebra; challenges/terminals: operand lists

    def base_transition_constraints(self, A, v) -> List:
        raise NotImplementedError

    def base_boundary_constraints(self, A, v) -> List:
        raise NotImplementedError

    def transition_constraints_ext(self, A, v, challenges) -> List:
        raise NotImplementedError

    def boundary_constraints_ext(self, A, v, challenges) -> List:
        raise NotImplementedError

    def terminal_constraints_ext(self, A, v, challenges, terminals) -> List:
        raise NotImplementedError

    def pad(self):
        """Grow the matrix to the next power of two in one allocation: the
        rows it has, then the padding block that `pad_rows` fills from the
        last row."""
        m = np.asarray(self.matrix, dtype=np.uint64).reshape(-1, self.base_width)
        rows = m.shape[0]
        self.height = roundup_npo2(rows)
        self.matrix = np.empty((self.height, self.base_width), dtype=np.uint64)
        self.matrix[:rows] = m
        if self.height > rows:
            self.pad_rows(self.matrix[rows:], m[-1])

    def pad_rows(self, block: np.ndarray, last: np.ndarray):
        """Write the padding rows `block` (n, base_width) that follow the
        row `last`, column by column."""
        raise NotImplementedError

    terminal_names: tuple = ()

    def extend_lanes(self, matrix, challenges, initials) -> List:
        """Affine-scan lanes of the extension columns (batched with the
        other tables' lanes into one scan by the prover)."""
        raise NotImplementedError

    def extend_finish(self, matrix, challenges, initials, outs):
        """Extension columns and terminals from the scanned lanes."""
        raise NotImplementedError

    def extend_pure(self, matrix, challenges, initials):
        """matrix: (H, base_width) int64; challenges: (11, 3); initials:
        (2, 3). Returns ((H, n_ext, 3) columns, (n_terminals, 3)
        terminals)."""
        lanes = self.extend_lanes(matrix, challenges, initials)
        outs = sc.batched_affine_scan(lanes)
        return self.extend_finish(matrix, challenges, initials, outs)

    # -- symbolic instantiation --------------------------------------------

    def _sym(self, n_vars: int, challenges_h, terminals_h=None, kind="transition"):
        A = SymbolicAlgebra(n_vars)
        v = SymExpr.variables(n_vars)
        ch = [SymExpr.constant(c) for c in challenges_h]
        if kind == "transition":
            return self.transition_constraints_ext(A, v, ch)
        if kind == "boundary":
            return self.boundary_constraints_ext(A, v, ch)
        tm = [SymExpr.constant(t) for t in terminals_h]
        return self.terminal_constraints_ext(A, v, ch, tm)

    def symbolic_transition_constraints(self, challenges_h) -> List[SymExpr]:
        return self._sym(2 * self.full_width, challenges_h, kind="transition")

    def symbolic_boundary_constraints(self, challenges_h) -> List[SymExpr]:
        return self._sym(self.full_width, challenges_h, kind="boundary")

    def symbolic_terminal_constraints(self, challenges_h, terminals_h) -> List[SymExpr]:
        return self._sym(self.full_width, challenges_h, terminals_h, kind="terminal")

    # -- degree bounds (ref table.py:180-184, 238-247, 288-292) ------------

    def boundary_quotient_degree_bounds(self, challenges_h) -> List[int]:
        d = [self.interpolant_degree()] * self.full_width
        return [
            c.symbolic_degree_bound(d) - 1
            for c in self.symbolic_boundary_constraints(challenges_h)
        ]

    def transition_quotient_degree_bounds(self, challenges_h) -> List[int]:
        d = [self.interpolant_degree()] * (2 * self.full_width)
        return [
            c.symbolic_degree_bound(d) - self.height + 1
            for c in self.symbolic_transition_constraints(challenges_h)
        ]

    def terminal_quotient_degree_bounds(self, challenges_h, terminals_h) -> List[int]:
        d = [self.interpolant_degree()] * self.full_width
        return [
            c.symbolic_degree_bound(d) - 1
            for c in self.symbolic_terminal_constraints(challenges_h, terminals_h)
        ]

    def all_quotient_degree_bounds(self, challenges_h, terminals_h) -> List[int]:
        return (
            self.boundary_quotient_degree_bounds(challenges_h)
            + self.transition_quotient_degree_bounds(challenges_h)
            + self.terminal_quotient_degree_bounds(challenges_h, terminals_h)
        )

    def num_quotients(self, challenges_h, terminals_h) -> int:
        return len(self.all_quotient_degree_bounds(challenges_h, terminals_h))

    # -- quotient evaluation (device or host; alg picks the device) --------

    def quotients(
        self,
        alg,
        point: List,
        point_next: List,
        challenges: List,
        terminals: List,
        zerofier_inv: Dict[str, object],
    ) -> List:
        """All quotient codewords for this table, in reference order
        boundary → transition → terminal (ref table.py:294-301): each
        constraint times its kind's zerofier inverse (`alg.quotient`).

        point/point_next: full_width operand lists over the evaluation
        domain; zerofier_inv: base-field arrays {'boundary', 'transition',
        'terminal'} (transition is all-zero when height == 0, reproducing
        ref table.py:196-199). Under `ProgramAlgebra` the operands are
        program nodes, zerofier_inv names the kinds, and the program
        records the outputs."""
        out = []
        for c in self.boundary_constraints_ext(alg, point, challenges):
            out.append(alg.quotient(c, zerofier_inv["boundary"]))
        for c in self.transition_constraints_ext(
            alg, point + point_next, challenges
        ):
            out.append(alg.quotient(c, zerofier_inv["transition"]))
        for c in self.terminal_constraints_ext(alg, point, challenges, terminals):
            out.append(alg.quotient(c, zerofier_inv["terminal"]))
        return out
