"""Processor table: 7 base registers + 4 extension columns.

AIR semantics match ref `processor_table.py:4-427` (per-instruction
deselector polynomials, inverse-witness rules for mv/mvi, running
permutation products against instruction and memory tables, running I/O
evaluations); the implementation is column tensors + parallel scans.
"""

from __future__ import annotations

import torch

from ..ops import scan as sc
from ..ops import xfield as xf
from .table import Table, clock_after

# base column indices (ref processor_table.py:6-12)
CLK, IP, CI, NI, MP, MV, MVI = range(7)
# extension column indices (ref processor_table.py:15-18)
INSTRUCTION_PERMUTATION, MEMORY_PERMUTATION, INPUT_EVALUATION, OUTPUT_EVALUATION = (
    7, 8, 9, 10,
)

INSTRUCTIONS = "[]<>+-,."


def if_instruction(A, instr: str, X):
    """Vanishes iff X == ord(instr) (ref processor_table.py:37-43)."""
    return A.const(ord(instr)) - X


def ifnot_instruction(A, instr: str, X):
    """Vanishes on every instruction except `instr` (ref :45-56)."""
    acc = A.one()
    for c in "[]<>,.+-":
        if c != instr:
            acc = acc * (X - A.const(ord(c)))
    return acc


def instruction_zerofier(A, X):
    """Vanishes on all eight instructions (ref :210-217)."""
    acc = A.one()
    for c in INSTRUCTIONS:
        acc = acc * (X - A.const(ord(c)))
    return acc


def _instruction_polynomials(A, instr, v):
    """Per-instruction transition rules (ref :58-128). v = 14 base vars."""
    (clk, ip, ci, ni, mp, mv, mvi,
     clk_n, ip_n, ci_n, ni_n, mp_n, mv_n, mvi_n) = v
    zero = A.zero()
    one = A.one()
    two = A.const(2)
    mv_is_zero = mv * mvi - one

    if instr == "[":
        p0 = mv * (ip_n - ip - two) + mv_is_zero * (ip_n - ni)
        p1 = mp_n - mp
        p2 = mv_n - mv
    elif instr == "]":
        p0 = mv_is_zero * (ip_n - ip - two) + mv * (ip_n - ni)
        p1 = mp_n - mp
        p2 = mv_n - mv
    elif instr == "<":
        p0 = ip_n - ip - one
        p1 = mp_n - mp + one
        p2 = zero  # memory value covered by the memory permutation argument
    elif instr == ">":
        p0 = ip_n - ip - one
        p1 = mp_n - mp - one
        p2 = zero
    elif instr == "+":
        p0 = ip_n - ip - one
        p1 = mp_n - mp
        p2 = mv_n - mv - one
    elif instr == "-":
        p0 = ip_n - ip - one
        p1 = mp_n - mp
        p2 = mv_n - mv + one
    elif instr == ",":
        p0 = ip_n - ip - one
        p1 = mp_n - mp
        p2 = zero  # set by the input evaluation argument
    elif instr == ".":
        p0 = ip_n - ip - one
        p1 = mp_n - mp
        p2 = mv_n - mv
    else:
        raise ValueError(instr)

    # deactivate on padding rows (ci == 0), ref :123-127
    return [p0 * ci, p1 * ci, p2 * ci]


def _base_transition(A, v):
    """Six base transition constraints (ref :130-171), max degree 11."""
    (clk, ip, ci, ni, mp, mv, mvi,
     clk_n, ip_n, ci_n, ni_n, mp_n, mv_n, mvi_n) = v
    one = A.one()

    # all eight deselectors share sub-products: with factors f_c = (ci - c)
    # over the deselector order "[]<>,.+-", deselector(instr at i) =
    # prefix[i] · suffix[i+1] — 16 muls instead of 8x6 (the polynomials are
    # identical to ifnot_instruction's, just factored once)
    DESEL_ORDER = "[]<>,.+-"
    factors = [ci - A.const(ord(c)) for c in DESEL_ORDER]
    n = len(factors)
    prefix = [A.one()]
    for fac in factors:
        prefix.append(prefix[-1] * fac)
    suffix = [A.one()]
    for fac in reversed(factors):
        suffix.append(suffix[-1] * fac)
    suffix = suffix[::-1]  # suffix[i] = product of factors[i:]

    polys = [A.zero(), A.zero(), A.zero()]
    for instr in INSTRUCTIONS:
        specific = _instruction_polynomials(A, instr, v)
        k = DESEL_ORDER.index(instr)
        deselector = prefix[k] * suffix[k + 1]
        for i in range(3):
            polys[i] = polys[i] + deselector * specific[i]

    polys.append(clk_n - clk - one)  # cycle always increments
    mv_is_zero = mv * mvi - one
    polys.append(mv * mv_is_zero)  # mvi is 0 or the inverse of mv
    polys.append(mvi * mv_is_zero)
    return polys


class ProcessorTable(Table):
    name = "processor"
    base_width = 7
    full_width = 11

    def pad_rows(self, block, last):
        """Padding rows: incrementing clk, frozen registers, ci = ni = 0
        (ref :24-35)."""
        block[:, CLK] = clock_after(last[CLK], len(block))
        block[:, [IP, MP, MV, MVI]] = last[[IP, MP, MV, MVI]]
        block[:, [CI, NI]] = 0

    # -- constraints --------------------------------------------------------

    def base_transition_constraints(self, A, v):
        return _base_transition(A, v)

    def base_boundary_constraints(self, A, v):
        # clk, ip, mp, mv, mvi all start at zero (ref :191-204)
        return [v[CLK], v[IP], v[MP], v[MV], v[MVI]]

    def transition_constraints_ext(self, A, v, challenges):
        a, b, c, d, e, f_, alpha, beta, gamma, delta, eta = challenges
        cur, nxt = v[:11], v[11:]
        base_vars = cur[:7] + nxt[:7]
        polys = _base_transition(A, base_vars)

        ci = cur[CI]
        # running product vs instruction table (ref :256-262)
        polys.append(
            (cur[INSTRUCTION_PERMUTATION]
             * (alpha - a * cur[IP] - b * ci - c * cur[NI])
             - nxt[INSTRUCTION_PERMUTATION]) * ci
            + instruction_zerofier(A, ci)
            * (cur[INSTRUCTION_PERMUTATION] - nxt[INSTRUCTION_PERMUTATION])
        )
        # running product vs memory table (ref :265-269)
        polys.append(
            (cur[MEMORY_PERMUTATION]
             * (beta - d * cur[CLK] - e * cur[MP] - f_ * cur[MV])
             - nxt[MEMORY_PERMUTATION]) * ci
            + (cur[MEMORY_PERMUTATION] - nxt[MEMORY_PERMUTATION])
            * instruction_zerofier(A, ci)
        )
        # input running evaluation (ref :271-272)
        polys.append(
            (nxt[INPUT_EVALUATION] - cur[INPUT_EVALUATION] * gamma - nxt[MV])
            * ifnot_instruction(A, ",", ci) * ci
            + (nxt[INPUT_EVALUATION] - cur[INPUT_EVALUATION])
            * if_instruction(A, ",", ci)
        )
        # output running evaluation (ref :274-275)
        polys.append(
            (nxt[OUTPUT_EVALUATION] - cur[OUTPUT_EVALUATION] * delta - cur[MV])
            * ifnot_instruction(A, ".", ci) * ci
            + (nxt[OUTPUT_EVALUATION] - cur[OUTPUT_EVALUATION])
            * if_instruction(A, ".", ci)
        )
        return polys

    def boundary_constraints_ext(self, A, v, challenges):
        # ref :282-302 (permutation columns are unconstrained at the
        # boundary: their secret initials are handled by the
        # cross-table permutation argument)
        return [
            v[CLK], v[IP], v[MP], v[MV], v[MVI],
            v[INPUT_EVALUATION], v[OUTPUT_EVALUATION],
        ]

    def terminal_constraints_ext(self, A, v, challenges, terminals):
        a, b, c, d, e, f_, alpha, beta, gamma, delta, eta = challenges
        airs = [terminals[0] - v[INSTRUCTION_PERMUTATION]]
        # memory permutation: one more factor may be pending on the last row
        # (ref :330-339)
        airs.append(
            (terminals[1]
             - v[MEMORY_PERMUTATION]
             * (beta - d * v[CLK] - e * v[MP] - f_ * v[MV])) * v[CI]
            + (terminals[1] - v[MEMORY_PERMUTATION])
            * instruction_zerofier(A, v[CI])
        )
        airs.append(terminals[2] - v[INPUT_EVALUATION])
        airs.append(terminals[3] - v[OUTPUT_EVALUATION])
        return airs

    # -- extension columns via parallel scans (ref :359-427) ---------------

    terminal_names = (
        "instruction_permutation", "memory_permutation",
        "input_evaluation", "output_evaluation",
    )

    def extend_lanes(self, m, challenges, initials):
        a, b, c, d, e, f_ = (challenges[i] for i in range(6))
        alpha, beta, gamma, delta = (challenges[i] for i in range(6, 10))
        H = m.shape[0]
        clk, ip, ci, ni, mp, mv = (m[:, i] for i in (CLK, IP, CI, NI, MP, MV))
        one = xf.ones((H,), m.device)
        zero = xf.zeros((H,), m.device)

        def lin3(ch0, c0, ch1, c1, ch2, c2, lhs):
            acc = xf.mul_base(ch0[None, :], c0)
            acc = xf.add(acc, xf.mul_base(ch1[None, :], c1))
            acc = xf.add(acc, xf.mul_base(ch2[None, :], c2))
            return xf.sub(lhs[None, :].expand(acc.shape), acc)

        active = (ci != 0)[:, None]

        # instruction permutation running product (exclusive; non-padding)
        fac1 = torch.where(active, lin3(a, ip, b, ci, c, ni, alpha), one)
        # memory permutation running product (exclusive; non-padding)
        fac2 = torch.where(active, lin3(d, clk, e, mp, f_, mv, beta), one)

        # input evaluation: x <- gamma*x + mv_next on ',' rows (exclusive;
        # the read value only lands in mv after the cycle)
        is_comma = (ci == ord(","))[:, None]
        mv_next = torch.roll(mv, -1, 0)
        ms3 = torch.where(is_comma, gamma[None, :].expand(H, 3), one)
        bs3 = torch.where(is_comma, xf.from_base(mv_next), zero)

        # output evaluation: x <- delta*x + mv on '.' rows (exclusive)
        is_dot = (ci == ord("."))[:, None]
        ms4 = torch.where(is_dot, delta[None, :].expand(H, 3), one)
        bs4 = torch.where(is_dot, xf.from_base(mv), zero)

        return [
            sc.prefix_mul_as_affine(fac1),
            sc.prefix_mul_as_affine(fac2),
            (ms3, bs3),
            (ms4, bs4),
        ]

    def extend_finish(self, m, challenges, initials, outs):
        inc1, inc2, inc3, inc4 = outs
        init_ip, init_mp = initials[0], initials[1]
        col_ip = sc.exclusive_from_inclusive(inc1, init_ip)
        term_ip = xf.mul(init_ip, inc1[-1])
        col_mp = sc.exclusive_from_inclusive(inc2, init_mp)
        term_mp = xf.mul(init_mp, inc2[-1])
        zero1 = xf.zeros((1,), m.device)
        col_in = torch.cat([zero1, inc3[:-1]], dim=0)
        col_out = torch.cat([zero1, inc4[:-1]], dim=0)
        cols = torch.stack([col_ip, col_mp, col_in, col_out], dim=1)
        terms = torch.stack([term_ip, term_mp, inc3[-1], inc4[-1]], dim=0)
        return cols, terms
