"""Memory table: 4 base columns (clk, mp, mv, dummy) + 1 extension column.

Memory-consistency table with the dummy-row mechanism that defeats the
clk-jump sorting attack (ref `memory_table.py:5-207`, docs/attack.md). The
matrix derivation itself lives in `vm.machine.derive_memory_matrix`.
"""

from __future__ import annotations

import torch

from ..ops import scan as sc
from ..ops import xfield as xf
from .table import Table, clock_after

CLK, MP, MV, DUMMY = range(4)
PERMUTATION = 4


def _base_transition(A, v):
    """Six base constraints (ref memory_table.py:46-93)."""
    clk, mp, mv, dummy, clk_n, mp_n, mv_n, dummy_n = v
    one = A.one()
    return [
        # memory pointer increases by one or stays
        (mp_n - mp - one) * (mp_n - mp),
        # if pointer increases, new cell starts at zero
        (mp_n - mp) * mv_n,
        # dummy is boolean
        (dummy_n - one) * dummy_n,
        # dummy rows freeze the pointer
        dummy * (mp_n - mp),
        # dummy rows freeze the value
        dummy * (mv_n - mv),
        # same pointer => clk increments by exactly one
        (mp_n - one - mp) * (clk_n - one - clk),
    ]


class MemoryTable(Table):
    name = "memory"
    base_width = 4
    full_width = 5

    def pad_rows(self, block, last):
        """Padding rows: incrementing clk, the last (mp, mv) repeated,
        dummy = 1 (ref :40-44)."""
        block[:, CLK] = clock_after(last[CLK], len(block))
        block[:, [MP, MV]] = last[[MP, MV]]
        block[:, DUMMY] = 1

    def base_transition_constraints(self, A, v):
        return _base_transition(A, v)

    def base_boundary_constraints(self, A, v):
        return [v[CLK], v[MP], v[MV]]

    def transition_constraints_ext(self, A, v, challenges):
        a, b, c, d, e, f_, alpha, beta, gamma, delta, eta = challenges
        cur, nxt = v[:5], v[5:]
        one = A.one()
        polys = _base_transition(A, cur[:4] + nxt[:4])
        # running product over non-dummy rows (ref :127-131)
        polys.append(
            (cur[PERMUTATION]
             * (beta - d * cur[CLK] - e * cur[MP] - f_ * cur[MV])
             - nxt[PERMUTATION]) * (one - cur[DUMMY])
            + (cur[PERMUTATION] - nxt[PERMUTATION]) * cur[DUMMY]
        )
        return polys

    def boundary_constraints_ext(self, A, v, challenges):
        return [v[CLK], v[MP], v[MV]]

    def terminal_constraints_ext(self, A, v, challenges, terminals):
        a, b, c, d, e, f_, alpha, beta, gamma, delta, eta = challenges
        one = A.one()
        perm = terminals[1]  # the processor's memory permutation terminal
        return [
            (v[PERMUTATION]
             * (beta - d * v[CLK] - e * v[MP] - f_ * v[MV])
             - perm) * (one - v[DUMMY])
            + (v[PERMUTATION] - perm) * v[DUMMY]
        ]

    terminal_names = ("permutation",)

    def extend_lanes(self, m, challenges, initials):
        d, e, f_, beta = (
            challenges[3], challenges[4], challenges[5], challenges[7],
        )
        H = m.shape[0]
        clk, mp, mv, dummy = (m[:, i] for i in range(4))
        acc = xf.mul_base(d[None, :], clk)
        acc = xf.add(acc, xf.mul_base(e[None, :], mp))
        acc = xf.add(acc, xf.mul_base(f_[None, :], mv))
        lin = xf.sub(beta[None, :].expand(acc.shape), acc)
        fac = torch.where((dummy == 0)[:, None], lin, xf.ones((H,), m.device))
        return [sc.prefix_mul_as_affine(fac)]

    def extend_finish(self, m, challenges, initials, outs):
        (inc,) = outs
        init_mp = initials[1]
        col = sc.exclusive_from_inclusive(inc, init_mp)
        term = xf.mul(init_mp, inc[-1])
        return col[:, None, :], term[None, :]
