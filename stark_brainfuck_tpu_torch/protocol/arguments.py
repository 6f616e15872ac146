"""Cross-table permutation and evaluation arguments.

Semantics per ref `permutation_argument.py` / `evaluation_argument.py`:

  - PermutationArgument: two extension columns (in different tables) carry
    running products that must share the same secret initial; the prover
    commits the difference quotient (lhs - rhs)/(X - 1), the verifier checks
    it at sampled points.
  - EvaluationArgument: the verifier recomputes a Horner-style running
    evaluation terminal from *public* symbols and compares with the claimed
    terminal.
  - ProgramEvaluationArgument: same, over the program with
    address-deduplication.

Host-side: these are O(|symbols|) scalar computations.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..ops import xfield as xf


class PermutationArgument:
    """lhs/rhs: (table_index, column_index) into the committed codeword
    layout (ref permutation_argument.py:5-34)."""

    def __init__(self, tables, lhs: Tuple[int, int], rhs: Tuple[int, int]):
        self.tables = tables
        self.lhs = lhs
        self.rhs = rhs

    def quotient_degree_bound(self) -> int:
        lhs_deg = self.tables[self.lhs[0]].interpolant_degree()
        rhs_deg = self.tables[self.rhs[0]].interpolant_degree()
        return max(lhs_deg, rhs_deg) - 1


def evaluation_terminal(symbols: Sequence[int], iota) -> tuple:
    """Horner running evaluation of public symbols (ref
    evaluation_argument.py:7-13, vm.py:312-318)."""
    acc = xf.H_ZERO
    for s in symbols:
        acc = xf.h_add(xf.h_mul(iota, acc), xf.h_from_base(int(s)))
    return acc


def program_evaluation_terminal(program: List[int], a, b, c, eta) -> tuple:
    """Running evaluation of (address, ci, ni) program rows with
    address-dedup — every address participates exactly once (ref
    evaluation_argument.py:25-50, vm.py:320-344)."""
    padded = [int(p) for p in program] + [0]
    running = xf.H_ZERO
    for i in range(len(padded) - 1):
        ci = padded[i]
        ni = padded[i + 1]
        term = xf.h_add(
            xf.h_add(
                xf.h_mul(a, xf.h_from_base(i)), xf.h_mul(b, xf.h_from_base(ci))
            ),
            xf.h_mul(c, xf.h_from_base(ni)),
        )
        running = xf.h_add(xf.h_mul(running, eta), term)
    # final row: last padded entry with ni = 0
    i = len(padded) - 1
    term = xf.h_add(
        xf.h_mul(a, xf.h_from_base(i)), xf.h_mul(b, xf.h_from_base(padded[i]))
    )
    running = xf.h_add(xf.h_mul(running, eta), term)
    return running
