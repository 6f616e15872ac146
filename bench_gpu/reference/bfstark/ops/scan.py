"""Parallel scans for the table-extension columns.

Running products and affine running evaluations are linear recurrences,
i.e. compositions in an associative monoid; they run as Hillis-Steele
scans (log2(H) full-width layers of extension-field multiplies) over all
extension lanes of all tables at once. A shift by d rows is a plain
concatenation of a fill block and the leading rows.
"""

from __future__ import annotations

import torch

from . import xfield as xf


def _shift_down_batched(x, d: int, fill):
    """Shift (K, H, 3) rows down by d along axis 1 (towards higher
    indices), filling the top with the monoid identity `fill` (3,)."""
    pad = fill.expand(x.shape[0], d, 3)
    return torch.cat([pad, x[:, :-d]], dim=1)


def prefix_mul_as_affine(factors):
    """An inclusive prefix product as an affine lane: x_i = f_i·x_{i-1} + b_i
    with b = (f_0, 0, 0, ...) gives x_i = Π_{j<=i} f_j from x_{-1} = 0."""
    b = torch.cat([factors[:1], torch.zeros_like(factors[1:])], dim=0)
    return factors, b


def batched_affine_scan(lanes):
    """Run many inclusive affine recurrences x_i = m_i·x_{i-1} + b_i
    (x_{-1} = 0) as one scan. `lanes`: list of (ms, bs) pairs, each
    (H_i, 3) — padded to the max height with the identity (m=1, b=0) and
    stacked to (K, Hmax, 3). Returns the inclusive outputs trimmed back to
    their own heights. Composition: (m1,b1) then (m2,b2) == (m2·m1,
    m2·b1 + b2)."""
    if not lanes:
        return []
    dev = lanes[0][0].device
    hmax = max(m.shape[0] for m, _ in lanes)
    one = xf.scalar(1, device=dev)
    zero = xf.scalar(0, device=dev)

    def pad(arr, fill):
        d = hmax - arr.shape[0]
        if d == 0:
            return arr
        return torch.cat([arr, fill.expand(d, 3)], dim=0)

    ms = torch.stack([pad(m, one) for m, _ in lanes], dim=0)  # (K, Hmax, 3)
    bs = torch.stack([pad(b, zero) for _, b in lanes], dim=0)
    d = 1
    while d < hmax:
        m_early = _shift_down_batched(ms, d, one)
        b_early = _shift_down_batched(bs, d, zero)
        bs = xf.add(xf.mul(ms, b_early), bs)
        ms = xf.mul(ms, m_early)
        d *= 2
    return [bs[k, : lanes[k][0].shape[0]] for k in range(len(lanes))]


def exclusive_from_inclusive(inclusive, initial):
    """Shift an inclusive prefix product right by one and premultiply by the
    initial value: out_i = initial · Π_{j<i} f_j."""
    one = xf.ones((1,), inclusive.device)
    shifted = torch.cat([one, inclusive[:-1]], dim=0)
    return xf.mul(initial.expand(shifted.shape), shifted)

