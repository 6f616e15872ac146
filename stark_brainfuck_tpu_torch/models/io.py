"""Input/Output tables: 1 base column + 1 running-evaluation column.

Bind the processor's I/O running evaluations to the public input/output
symbol streams (ref `io_table.py:4-128`). num_randomizers is 0 — these
columns are public data (ref io_table.py:12).
"""

from __future__ import annotations

import numpy as np

from ..ops import xfield as xf
from .table import Table, derive_omicron

COLUMN = 0
EVALUATION = 1


class IOTable(Table):
    name = "io"
    base_width = 1
    full_width = 2
    challenge_index: int
    terminal_index: int

    def __init__(self, length: int):
        super().__init__(length, num_randomizers=0)

    def pad(self):
        """Zero-pad to a power of two; length is re-pinned to the number of
        real symbols first (ref io_table.py:16-20)."""
        self.length = np.size(self.matrix)
        super().pad()
        self.omicron = derive_omicron(self.height)

    def pad_rows(self, block, last):
        block[:] = 0

    def base_transition_constraints(self, A, v):
        return []

    def base_boundary_constraints(self, A, v):
        return []

    def transition_constraints_ext(self, A, v, challenges):
        col, ev, col_n, ev_n = v
        iota = challenges[self.challenge_index]
        return [ev * iota + col_n - ev_n]

    def boundary_constraints_ext(self, A, v, challenges):
        return [v[EVALUATION] - v[COLUMN]]

    def terminal_constraints_ext(self, A, v, challenges, terminals):
        # padding rows keep multiplying the running evaluation by iota, so
        # the last row holds terminal * iota^(height - length) (ref :52-74)
        iota_h = challenges[self.challenge_index]
        offset = iota_h ** (self.height - self.length)
        return [v[EVALUATION] - terminals[self.terminal_index] * offset]

    terminal_names = ("evaluation",)

    def extend_lanes(self, m, challenges, initials):
        H = m.shape[0]
        if H == 0:
            return []
        iota = challenges[self.challenge_index]
        return [(iota[None, :].expand(H, 3), xf.from_base(m[:, COLUMN]))]

    def extend_finish(self, m, challenges, initials, outs):
        H = m.shape[0]
        if H == 0:
            return xf.zeros((0, 1), m.device), xf.zeros((1,), m.device)
        (ev,) = outs
        if self.length > 0:
            terminal = ev[self.length - 1]
        else:
            terminal = xf.scalar(0, device=m.device)
        return ev[:, None, :], terminal[None, :]


class InputTable(IOTable):
    name = "input"
    challenge_index = 8
    terminal_index = 2


class OutputTable(IOTable):
    name = "output"
    challenge_index = 9
    terminal_index = 3
