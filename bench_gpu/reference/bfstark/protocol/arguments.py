"""Cross-table permutation arguments (ref `permutation_argument.py`): two
extension columns (in different tables) carry running products that must
share the same secret initial; the prover commits the difference quotient
(lhs - rhs)/(X - 1)."""

from __future__ import annotations

from typing import Tuple


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

