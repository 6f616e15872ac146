"""FRI's fold round: kernel F5 (`csrc/fri.cu`) on the card, the host tail's
fold (`native/fri_host.cpp`) on the CPU, and the plain torch fold.

One round maps an (N, 3) codeword of F_p^3 values to the N/2 values
new[i] = 2^-1·((1 + α/x_i)·cw[i] + (1 - α/x_i)·cw[i+N/2]), with 1/x_i =
s·r^i, r = omega^-1 and s = offset^-1·r^start_index (the start index is
a mesh rank's first folded index, 0 on one device).

  - `fold` is a device round: a CUDA codeword goes to F5, one launch, and
    raises if it cannot; a CPU codeword takes `fold_plain`.
  - `fold_host` is a host round (the JAX package's numpy tail): the g++
    build of F5's body on a CPU codeword, on every device; a failed build
    raises with g++'s output.
  - `fold_plain` is `fold_math` on a `geometric_rows` table of 1/x_i, op
    by op on the field layer: the oracle of both, and the CPU route.

Codewords are contiguous (N, 3) int64 tensors with the u64 bits of
canonical field elements (`convert.py`), N even; the result is a new
(N/2, 3) tensor. The constants of a round (α, 2^-1, s and the ladder
r^(2^k), k < LADDER) are computed on the host and passed by value
(`fold_words`), so a round uploads nothing. The libraries build at first
use; nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .. import native
from ..convert import u64_to_tensor
from . import cuda_build
from . import field as f
from . import xfield as xf

# launches of F5 since import (or since a caller reset it)
LAUNCHES_FOLD = 0

LADDER = 32  # csrc/fri.cuh kFoldLadder
FOLD_WORDS = 5 + LADDER  # csrc/fri.cuh kFoldWords
TWO_INV = f.h_inverse(2)

_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("fri")
        lib.fri_fold_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.fri_fold_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fold_math(cw, alpha, ixs):
    """new[i] = 2^-1·((1 + α/x_i)·cw[i] + (1 - α/x_i)·cw[i+N/2])
    (ref fri.py:127-128). ixs = 1/x_i for the half-domain."""
    half = cw.shape[0] // 2
    a_over_x = xf.mul_base(alpha[None, :].expand(half, 3), ixs)
    one = xf.ones((half,), cw.device)
    lo = xf.mul(xf.add(one, a_over_x), cw[:half])
    hi = xf.mul(xf.sub(one, a_over_x), cw[half:])
    return f.mul(xf.add(lo, hi), f.const(f.h_inverse(2), cw))


# a prove's rounds fold on the same few (omega, offset) pairs: their
# inverses and ladders are computed once (an inverse takes about 25 us)
@functools.lru_cache(maxsize=256)
def _inverse(x: int) -> int:
    return f.h_inverse(x)


@functools.lru_cache(maxsize=256)
def _ladder(omega: int) -> tuple:
    """r^(2^k) for k < LADDER, r = omega^-1."""
    r, out = _inverse(omega), []
    for _ in range(LADDER):
        out.append(r)
        r = f.h_mul(r, r)
    return tuple(out)


def _start(omega: int, offset: int, start_index: int) -> int:
    """s = 1/x_0 of the fold: offset^-1·omega^-start_index."""
    return f.h_mul(_inverse(offset), f.h_pow(_inverse(omega), start_index))


def fold_plain(codeword, alpha: Sequence[int], omega: int, offset: int,
               start_index: int = 0):
    """The fold op by op where the codeword lies: 1/x_i by log-depth
    doubling (`geometric_rows`), then `fold_math`."""
    half = int(codeword.shape[0]) // 2
    seeds = u64_to_tensor([_start(omega, offset, start_index),
                           _inverse(omega)], codeword.device)
    ixs = f.geometric_rows(seeds[0:1], seeds[1:2], half)[0]
    alpha_t = u64_to_tensor(list(alpha), codeword.device)
    return fold_math(codeword, alpha_t, ixs)


def fold_words(alpha: Sequence[int], omega: int, offset: int,
               start_index: int = 0) -> "ctypes.Array":
    """A round's FOLD_WORDS constants as csrc/fri.cuh `fri_fold_args` reads
    them: α, 2^-1, s, then r^(2^k) for k < LADDER."""
    return (ctypes.c_ulonglong * FOLD_WORDS)(
        *(int(a) for a in alpha), TWO_INV,
        _start(omega, offset, start_index), *_ladder(omega))


def _checked(codeword, alpha, start_index: int) -> int:
    """N/2 of a codeword the fold takes; raises for any other."""
    if codeword.dtype != torch.int64:
        raise ValueError(f"a fold takes an int64 codeword, not "
                         f"{codeword.dtype}")
    shape = tuple(codeword.shape)
    if len(shape) != 2 or shape[1] != 3 or shape[0] < 2 or shape[0] % 2:
        raise ValueError(f"a fold takes an (N, 3) codeword, N even, not "
                         f"{shape}")
    if not codeword.is_contiguous():
        raise ValueError("a fold takes a contiguous codeword")
    if len(alpha) != 3:
        raise ValueError(f"α has {len(alpha)} coefficients, not 3")
    if not 0 <= start_index < 1 << LADDER:
        raise ValueError(f"start index {start_index} outside the ladder")
    return shape[0] // 2


def fold(codeword, alpha: Sequence[int], omega: int, offset: int,
         start_index: int = 0):
    """One device fold round: F5 on a CUDA codeword (one launch, counted in
    LAUNCHES_FOLD; a failed launch raises), `fold_plain` on a CPU one."""
    global LAUNCHES_FOLD
    half = _checked(codeword, alpha, start_index)
    device = codeword.device
    if device.type == "cpu":
        return fold_plain(codeword, alpha, omega, offset, start_index)
    if device.type != "cuda":
        raise ValueError(f"no fold kernel for device {device}")
    out = codeword.new_empty((half, 3))
    words = fold_words(alpha, omega, offset, start_index)
    fn = _kernel_lib().fri_fold_launch
    with torch.cuda.device(device):
        rc = fn(codeword.data_ptr(), half, words, out.data_ptr(),
                _stream(device))
    if rc != 0:
        raise RuntimeError(f"fri_fold_launch failed: cudaError {rc}")
    LAUNCHES_FOLD += 1
    return out


def fold_host(codeword, alpha: Sequence[int], omega: int, offset: int,
              start_index: int = 0):
    """One host fold round on a CPU codeword, through the g++ build of F5's
    body (`native/fri_host.cpp`): the buffer is read where it lies and the
    result written into a new tensor. Raises for a codeword elsewhere."""
    half = _checked(codeword, alpha, start_index)
    if codeword.device.type != "cpu":
        raise ValueError(f"the host fold takes a CPU codeword, not one on "
                         f"{codeword.device}")
    out = codeword.new_empty((half, 3))
    native.get_fri_lib().fri_fold_host(
        codeword.data_ptr(), half, fold_words(alpha, omega, offset,
                                              start_index), out.data_ptr())
    return out
