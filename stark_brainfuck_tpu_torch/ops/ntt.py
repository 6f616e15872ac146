"""Iterative radix-2 NTT / INTT, coset evaluation, and randomized LDE.

The u64 butterfly network of the JAX package's `ops/ntt.py`, on torch:
every stage is a reshape plus broadcast field mul/add/sub over whole row
batches (shape (B, n)); sizes from `FOUR_STEP_MIN` up run as a four-step
transform (two batched ~sqrt(n) NTTs around a twiddle multiply). Trace
interpolation is a subgroup INTT plus the additive randomization
f(x) = trace_poly(x) + (x^H - 1)·r(x). Twiddle tables are built once on
the host and moved to the device in a pack.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch

from ..convert import to_i64
from ..utils.metrics import transfer
from . import field as f
from .field import P


class TwiddlePack(NamedTuple):
    """Tables for one (n, root) NTT: the bit-reversal permutation and the
    per-stage twiddle arrays."""

    perm: object  # (n,) int64 indices
    stages: Tuple  # stage s (1-based): (2^(s-1),) twiddles
    n_inv: Optional[object] = None  # () scalar — set for inverse transforms


class FourStepPack(NamedTuple):
    """Tables for a four-step NTT of size n = R·C: two small sub-packs and
    the (R, C) inter-step twiddle matrix T[k1, c] = root^(c·k1)."""

    pack_r: TwiddlePack
    pack_c: TwiddlePack
    twiddle: object  # (R, C)
    n_inv: Optional[object] = None


FOUR_STEP_MIN = 1 << 14


@lru_cache(maxsize=None)
def _bitrev_permutation(n: int) -> torch.Tensor:
    logn = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64)
    rev = torch.zeros(n, dtype=torch.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


@lru_cache(maxsize=None)
def _stage_twiddles(n: int, root: int) -> tuple:
    """Stage s (m = 2^s) needs [w_m^j for j < m/2] with w_m = root^(n/m): a
    strided slice of the full power table (host tensors)."""
    full = f.powers(root, max(n // 2, 1))
    tables = []
    logn = n.bit_length() - 1
    for s in range(1, logn + 1):
        m = 1 << s
        tables.append(full[:: n // m][: m // 2].contiguous())
    return tuple(tables)


def _inv_scalar(n: int, device):
    return transfer(
        torch.tensor(to_i64(f.h_inverse(n % P)), dtype=torch.int64), device
    )


def make_pack(n: int, root: int, inverse: bool = False, device=None):
    """The twiddle pack for a size-n transform, on `device`; large sizes
    get a FourStepPack."""
    if n >= FOUR_STEP_MIN:
        return _make_four_step_pack(n, root, inverse, device)
    return _make_small_pack(n, root, inverse, device)


def _make_small_pack(n: int, root: int, inverse: bool, device) -> TwiddlePack:
    if n <= 1:
        return TwiddlePack(
            perm=torch.zeros((max(n, 1),), dtype=torch.int64, device=device),
            stages=(),
            n_inv=_inv_scalar(1, device) if inverse else None,
        )
    r = f.h_inverse(root) if inverse else root
    return TwiddlePack(
        perm=transfer(_bitrev_permutation(n), device),
        stages=tuple(transfer(s, device) for s in _stage_twiddles(n, r)),
        n_inv=_inv_scalar(n, device) if inverse else None,
    )


def _make_four_step_pack(n: int, root: int, inverse: bool, device):
    logn = n.bit_length() - 1
    R = 1 << (logn // 2)
    C = n // R
    r = f.h_inverse(root) if inverse else root
    pack_r = _make_small_pack(R, f.h_pow(r, C), False, device)
    pack_c = _make_small_pack(C, f.h_pow(r, R), False, device)
    # T[k1, c] = r^(k1·c) as geometric rows: start 1, ratio r^k1
    ratios = f.powers(r, R, device)
    T = f.geometric_rows(torch.ones_like(ratios), ratios, C)
    return FourStepPack(
        pack_r=pack_r, pack_c=pack_c, twiddle=T,
        n_inv=_inv_scalar(n, device) if inverse else None,
    )


def ntt_with(values, pack, plain: bool = False):
    """Transform along the last axis with a precomputed pack.
    Forward: out[k] = Σ_j v[j]·root^(jk); with pack.n_inv set the result is
    scaled by it (inverse transform). `plain` runs the radix-2 network on
    the plain field operations on any device (kernel B2's yardstick), not
    on kernel F1."""
    mul, add, sub = ((f.mul_plain, f.add_plain, f.sub_plain) if plain
                     else (f.mul, f.add, f.sub))
    if isinstance(pack, FourStepPack):
        if plain:
            raise ValueError("the plain network takes a radix-2 pack")
        return _ntt_four_step(values, pack)
    n = values.shape[-1]
    if n <= 1:
        return values
    shape = values.shape
    x = values.reshape((-1, n))[:, pack.perm]
    b = x.shape[0]
    logn = n.bit_length() - 1
    for s in range(1, logn + 1):
        m = 1 << s
        half = m >> 1
        tw = pack.stages[s - 1]
        x = x.reshape((b, n // m, m))
        even = x[:, :, :half]
        odd = x[:, :, half:]
        t = mul(odd, tw[None, None, :])
        x = torch.cat([add(even, t), sub(even, t)], dim=-1)
    x = x.reshape(shape)
    if pack.n_inv is not None:
        x = mul(x, pack.n_inv)
    return x


def _ntt_four_step(values, pack: FourStepPack):
    """Size-n = R·C NTT: column DFT_R → twiddle → row DFT_C → transpose.
    With x[j] = X[r, c] at j = r·C + c, the natural-order output is the
    (C, R) row-major flatten of Z[k1][k2]."""
    shape = values.shape
    R, C = pack.twiddle.shape
    n = R * C
    x = values.reshape((-1, R, C))
    y = x.transpose(1, 2)  # (B, C, R)
    y = ntt_with(y, pack.pack_r)  # DFT over r; y[b, c, k1]
    y = f.mul(y, pack.twiddle.transpose(0, 1)[None])
    y = y.transpose(1, 2)  # (B, k1, c)
    y = ntt_with(y, pack.pack_c)  # DFT over c; y[b, k1, k2]
    y = y.transpose(1, 2)  # (B, k2, k1) — natural order flatten
    out = y.reshape(shape[:-1] + (n,))
    if pack.n_inv is not None:
        out = f.mul(out, pack.n_inv)
    return out


# -- convenience wrappers: root given as an int -------------------------------


def ntt(values, root: int):
    return ntt_with(values, make_pack(values.shape[-1], root, False, values.device))


def intt(values, root: int):
    return ntt_with(values, make_pack(values.shape[-1], root, True, values.device))


def scale_table(offset: int, count: int, device=None):
    """[offset^0 .. offset^(count-1)] for evaluate-on-coset shifts."""
    return f.powers(offset, count, device)


def _pad_to(x, length: int):
    d = x.shape[-1]
    if d >= length:
        return x
    pad = torch.zeros(x.shape[:-1] + (length - d,), dtype=torch.int64,
                      device=x.device)
    return torch.cat([x, pad], dim=-1)


def coset_evaluate_with(coeffs, scale, fwd_pack, length: int):
    """Evaluate polynomials (coefficient rows (..., d)) on the coset of size
    `length` with a precomputed scale table (d,) and forward pack."""
    d = coeffs.shape[-1]
    assert d <= length
    return ntt_with(_pad_to(f.mul(coeffs, scale[:d]), length), fwd_pack)


def coset_evaluate(coeffs, offset: int, root: int, length: int):
    """Evaluate polynomials (coefficient rows (..., d)) on the coset
    offset·<root> of size `length`: `FriDomain.evaluate`/`xevaluate`, the
    JAX package's API, which no prover path calls (held to the JAX
    package's by `tests/test_torch_fri.py`)."""
    return coset_evaluate_with(
        coeffs, scale_table(offset, coeffs.shape[-1], coeffs.device),
        make_pack(length, root, False, coeffs.device), length,
    )


def coset_interpolate(values, offset: int, root: int):
    """Inverse of coset evaluation (host/verifier use)."""
    n = values.shape[-1]
    coeffs = ntt_with(values, make_pack(n, root, True, values.device))
    return f.mul(coeffs, scale_table(f.h_inverse(offset), n, values.device))


# -- randomized LDE ---------------------------------------------------------


def _randomized_coefficients(trace, randomizers, intt_pack):
    """Subgroup INTT of the trace rows plus the (x^H - 1)·r(x) blinding.
    `intt_pack` is a pack of this module or a kernel plan of
    `ops/kernel_ntt.py` (`forward_ntt` takes either)."""
    from .kernel_ntt import forward_ntt  # kernel_ntt imports this module

    H = trace.shape[-1]
    coeffs = forward_ntt(trace, intt_pack)
    if randomizers is not None and randomizers.shape[-1] > 0:
        R = randomizers.shape[-1]
        assert R <= H, "num_randomizers must not exceed the trace height"
        head = f.sub(coeffs[..., :R], randomizers)
        coeffs = torch.cat([head, coeffs[..., R:], randomizers], dim=-1)
    return coeffs


def lde_coefficients_unpadded(trace, randomizers, intt_pack, scale):
    """Coset-scaled coefficient rows of the randomized LDE at their natural
    length H (+R): the persistent per-row state of the streamed prover,
    which evaluates them class by class instead of through one padded
    full-domain NTT."""
    coeffs = _randomized_coefficients(trace, randomizers, intt_pack)
    return f.mul(coeffs, scale[: coeffs.shape[-1]])


def lde_coefficients(trace, randomizers, intt_pack, scale, length: int):
    """Coset-scaled, zero-padded coefficient rows of the randomized LDE,
    ready to batch into one shared forward NTT across tables."""
    return _pad_to(
        lde_coefficients_unpadded(trace, randomizers, intt_pack, scale), length
    )


def lde_columns_with(trace, randomizers, intt_pack, scale, fwd_pack,
                     fri_length: int):
    """Randomized LDE: trace (W, H) over the omicron subgroup ->
    (W, fri_length) codewords of f(x) = trace_poly(x) + (x^H - 1)·r(x).
    `scale`: offset powers table of length >= H + R."""
    coeffs = _randomized_coefficients(trace, randomizers, intt_pack)
    return coset_evaluate_with(coeffs, scale, fwd_pack, fri_length)


def lde_xcolumns_with(trace, randomizers, intt_pack, scale, fwd_pack,
                      fri_length: int):
    """Extension-field variant: trace (W, H, 3) -> (W, fri_length, 3); the
    coefficient axis rides along as a batch dim."""
    t = trace.movedim(-1, 0)  # (3, W, H)
    flat_r = None
    if randomizers is not None:
        r = randomizers.movedim(-1, 0)
        flat_r = r.reshape((-1, r.shape[-1]))
    out = lde_columns_with(
        t.reshape((-1, t.shape[-1])), flat_r, intt_pack, scale, fwd_pack,
        fri_length,
    )
    out = out.reshape((3,) + tuple(trace.shape[:-2]) + (fri_length,))
    return out.movedim(0, -1)
