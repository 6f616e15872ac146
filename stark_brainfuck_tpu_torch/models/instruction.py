"""Instruction table: 3 base columns (addr, ci, ni) + 2 extension columns.

Links the processor's (ip, ci, ni) tuples to the program through a
permutation (subset) argument and binds the program itself through an
evaluation argument with address-deduplication (ref
`instruction_table.py:5-231`).
"""

from __future__ import annotations

import torch

from ..ops import scan as sc
from ..ops import xfield as xf
from .processor import instruction_zerofier
from .table import Table

ADDRESS, CURRENT_INSTRUCTION, NEXT_INSTRUCTION = range(3)
PERMUTATION, EVALUATION = 3, 4


def _base_transition(A, v):
    """Four base constraints (ref instruction_table.py:27-46)."""
    addr, ci, ni, addr_n, ci_n, ni_n = v
    one = A.one()
    return [
        # address increases by zero or one
        (addr_n - addr - one) * (addr_n - addr),
        # on address change, ni chains into the next row's ci
        (addr_n - addr) * (ni - ci_n),
        # same address => same current instruction
        (addr_n - addr - one) * (ci_n - ci),
        # same address => same next instruction
        (addr_n - addr - one) * (ni_n - ni),
    ]


class InstructionTable(Table):
    name = "instruction"
    base_width = 3
    full_width = 5

    def pad_rows(self, block, last):
        """Padding rows: the last address repeated, ci = ni = 0
        (ref :19-25)."""
        block[:, ADDRESS] = last[ADDRESS]
        block[:, [CURRENT_INSTRUCTION, NEXT_INSTRUCTION]] = 0

    def base_transition_constraints(self, A, v):
        return _base_transition(A, v)

    def base_boundary_constraints(self, A, v):
        return [v[ADDRESS]]

    def transition_constraints_ext(self, A, v, challenges):
        a, b, c, d, e, f_, alpha, beta, gamma, delta, eta = challenges
        cur, nxt = v[:5], v[5:]
        one = A.one()
        polys = _base_transition(A, cur[:3] + nxt[:3])

        # permutation running product absorbs the *next* row when the
        # address repeats and the row is not padding (ref :84-92)
        polys.append(
            (cur[PERMUTATION]
             * (alpha - a * nxt[ADDRESS] - b * nxt[CURRENT_INSTRUCTION]
                - c * nxt[NEXT_INSTRUCTION])
             - nxt[PERMUTATION])
            * cur[CURRENT_INSTRUCTION]
            * (cur[ADDRESS] + one - nxt[ADDRESS])
            + instruction_zerofier(A, cur[CURRENT_INSTRUCTION])
            * (cur[PERMUTATION] - nxt[PERMUTATION])
            + (cur[ADDRESS] - nxt[ADDRESS])
            * (cur[PERMUTATION] - nxt[PERMUTATION])
        )

        # program evaluation absorbs each *new* address (ref :94-109)
        ifnew = nxt[ADDRESS] - cur[ADDRESS]
        ifold = nxt[ADDRESS] - cur[ADDRESS] - one
        polys.append(
            ifnew
            * (cur[EVALUATION] * eta
               + a * nxt[ADDRESS]
               + b * nxt[CURRENT_INSTRUCTION]
               + c * nxt[NEXT_INSTRUCTION]
               - nxt[EVALUATION])
            + ifold * (cur[EVALUATION] - nxt[EVALUATION])
        )
        return polys

    def boundary_constraints_ext(self, A, v, challenges):
        a, b, c, d, e, f_, alpha, beta, gamma, delta, eta = challenges
        # address starts at zero; evaluation starts with the first row
        # already absorbed (ref :113-126)
        return [
            v[ADDRESS],
            v[EVALUATION]
            - a * v[ADDRESS]
            - b * v[CURRENT_INSTRUCTION]
            - c * v[NEXT_INSTRUCTION],
        ]

    def terminal_constraints_ext(self, A, v, challenges, terminals):
        # terminals[0]: processor's instruction permutation terminal;
        # terminals[4]: this table's program evaluation terminal (ref :128-169)
        return [
            v[PERMUTATION] - terminals[0],
            v[EVALUATION] - terminals[4],
        ]

    terminal_names = ("permutation", "evaluation")

    def _lane_inputs(self, m, challenges):
        a, b, c = challenges[0], challenges[1], challenges[2]
        alpha, eta = challenges[6], challenges[10]
        H = m.shape[0]
        addr, ci, ni = (m[:, i] for i in range(3))
        one = xf.ones((H,), m.device)

        acc = xf.mul_base(a[None, :], addr)
        acc = xf.add(acc, xf.mul_base(b[None, :], ci))
        acc = xf.add(acc, xf.mul_base(c[None, :], ni))
        row_val = acc  # a·addr + b·ci + c·ni per row

        # same_addr[i] == (i > 0 and addr[i] == addr[i-1])
        same_addr = torch.zeros((H,), dtype=torch.bool, device=m.device)
        if H > 0:
            same_addr[1:] = addr[1:] == addr[:-1]

        # permutation: inclusive product over repeated-address, non-padding
        # rows of (alpha - row_val)
        lin = xf.sub(alpha[None, :].expand(H, 3), row_val)
        active = (same_addr & (ci != 0))[:, None]
        fac = torch.where(active, lin, one)

        # evaluation: inclusive affine recurrence absorbing new addresses
        is_new = (~same_addr)[:, None]
        ms = torch.where(is_new, eta[None, :].expand(H, 3), one)
        bs = torch.where(is_new, row_val, xf.zeros((H,), m.device))
        return fac, ms, bs

    def extend_lanes(self, m, challenges, initials):
        fac, ms, bs = self._lane_inputs(m, challenges)
        return [sc.prefix_mul_as_affine(fac), (ms, bs)]

    def extend_finish(self, m, challenges, initials, outs):
        inc, col_eval = outs
        init_ip = initials[0]
        H = m.shape[0]
        col_perm = xf.mul(init_ip[None, :].expand(H, 3), inc)
        term_perm = col_perm[-1] if H > 0 else init_ip
        term_eval = col_eval[-1] if H > 0 else xf.scalar(0, device=m.device)
        cols = torch.stack([col_perm, col_eval], dim=1)
        terms = torch.stack([term_perm, term_eval], dim=0)
        return cols, terms
