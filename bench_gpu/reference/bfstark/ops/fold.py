"""One FRI fold round as torch ops on the plain field operations (the
port's `ops/fri_kernels.py` `fold_plain` and `fold_math`), on any device."""

from __future__ import annotations

import functools
from typing import Sequence

from ..convert import u64_to_tensor
from . import field as f
from . import xfield as xf


def fold_math(cw, alpha, ixs):
    """new[i] = 2^-1·((1 + α/x_i)·cw[i] + (1 - α/x_i)·cw[i+N/2])
    (ref fri.py:127-128). ixs = 1/x_i for the half-domain."""
    half = cw.shape[0] // 2
    a_over_x = xf.mul_base(alpha[None, :].expand(half, 3), ixs)
    one = xf.ones((half,), cw.device)
    lo = xf.mul(xf.add(one, a_over_x), cw[:half])
    hi = xf.mul(xf.sub(one, a_over_x), cw[half:])
    return f.mul(xf.add(lo, hi), f.const(f.h_inverse(2), cw))


@functools.lru_cache(maxsize=256)
def _inverse(x: int) -> int:
    return f.h_inverse(x)


def fold_plain(codeword, alpha: Sequence[int], omega: int, offset: int):
    """The fold op by op where the codeword lies: 1/x_i by log-depth
    doubling (`geometric_rows`) from offset^-1, then `fold_math`."""
    half = int(codeword.shape[0]) // 2
    seeds = u64_to_tensor([_inverse(offset), _inverse(omega)],
                          codeword.device)
    ixs = f.geometric_rows(seeds[0:1], seeds[1:2], half)[0]
    alpha_t = u64_to_tensor(list(alpha), codeword.device)
    return fold_math(codeword, alpha_t, ixs)
