"""Four-step Goldilocks NTT on kernels B2 and B3: every NTT of the port.

The counterpart of the JAX package's `ops/pallas_ntt.py`: the same
transform, bit-identical to the u64 butterfly network of the JAX package's
`ops/ntt.py`. The four-step split (`plan_geometry`) and the order of its
passes are the port's own, chosen for the card. `ntt_backend` chooses
nothing here: every value runs this transform (B2/B3 on a CUDA tensor,
their plain versions on a CPU tensor).

The representation differs. The TPU kernels hold each element as 9
balanced int8 limbs, plane-major, so that the radix-128/64 DFTs run as int8
matrix products on the MXU and twiddles are limb convolutions
(`ops/limb.py`, `ops/mxu_ntt.py`). Hopper multiplies 64-bit words natively,
so the port's kernels take the canonical u64 words (int64 tensors, as
everywhere in the port); the limb modules have no counterpart here.

  - `subntt_tiled` (B2, `csrc/ntt.cu` `subntt_kernel`): an NTT of
    m <= 2^13 points of every vector of a strided batch, radix-8 Stockham
    steps in registers and shared memory, stored under other strides if
    asked; `subntt` is its contiguous-rows form;
  - `twiddle_outer` (B3, `twiddle_outer_kernel`): row g, column j times
    w^((g mod c)·j) from the factored hi/lo tables;
  - `ntt_kernel`: the full n-point transform (n <= 2^26) composed of them,
    with the four-step transposes inside B2's own loads and stores.

What the kernel's schedule needs from the host is here, in Python that
the CPU tests reach: the step radices, the between-step twiddle table, the
exponent kappa of the sub-root's 8th root, the tile shape.

A wrapper given a CUDA tensor launches its kernel (or raises); given a CPU
tensor it runs its plain torch version (`subntt_plain`,
`subntt_tiled_plain`, `twiddle_outer_plain`); any other device raises.
B2's plain version is the radix-2 butterfly network (`network_ntt`, on the
plain field operations), which `chip_smoke.py` also holds the composed
transform to on the card.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch

from ..convert import to_i64
from ..utils.metrics import transfer
from . import cuda_build
from . import field as f

SUB_MAX = 1 << 13  # largest sub-transform
KERNEL_NTT_MAX = 1 << 26  # n = r·c with r, c <= SUB_MAX

# B2's tile: a block holds 2^log_vo groups of 2^log_ti adjacent vectors in
# shared memory, 8 words a thread, so at most 2^MAX_LOG_TILE words with its
# 1,024 threads. LOG_TILE is the size aimed at (words, log2) and
# LOG_TI_STRIDED the adjacent vectors wanted where a vector's elements are
# strided in memory, so that every access still covers whole 32-byte
# sectors. On the H100 the kernel's time is the same within 3 % from 2^11
# to 2^13 words and for 4 or 8 adjacent vectors (`chip_smoke.py --b2-sweep`)
LOG_TILE = 11
MAX_LOG_TILE = 13
LOG_TI_STRIDED = 3

# launches of each CUDA kernel since import (or since a caller reset them)
LAUNCHES_SUBNTT = 0
LAUNCHES_TWIDDLE = 0


class TwiddlePack(NamedTuple):
    """Tables of the radix-2 network for one (n, root): the bit-reversal
    permutation and the per-stage twiddle arrays."""

    perm: object  # (n,) int64 indices
    stages: Tuple  # stage s (1-based): (2^(s-1),) twiddles
    n_inv: Optional[object] = None  # () scalar — set for inverse transforms


class SubPlan(NamedTuple):
    """One m-point sub-transform: the radix-2 tables of the plain version,
    the kernel's between-step twiddles and 8th-root exponent, and the
    factor applied to every output."""

    m: int
    pack: TwiddlePack
    scale: int  # 1, or n^-1 for the last sub-NTT of an inverse plan
    table: torch.Tensor  # `step_table(m, root)`
    kappa: int  # `root_kappa(m, root)`


class KernelNttPlan(NamedTuple):
    n: int
    r: int  # n = r·c; c == 1 for a single sub-transform
    c: int
    sub_r: SubPlan
    sub_c: Optional[SubPlan]
    tw_hi: Optional[torch.Tensor]  # (c // 128, r): w^(128·b_hi·j)
    tw_lo: Optional[torch.Tensor]  # (128, r): w^(b_lo·j)


class Strides(NamedTuple):
    """Where a batch of vectors lies in a flat tensor, in words: element i
    of vector v of batch b is at b·batch + v·vec + i·elem."""

    batch: int
    vec: int
    elem: int


def plan_geometry(n: int) -> Tuple[int, int]:
    """(r, c) with n = r·c: one sub-transform up to 2^13 points (n = 1, a
    table of height 1, is the identity), else the balanced split
    c = 2^max(7, floor(log n / 2)), r = n / c >= c. Both sub-transforms
    then fit a block's shared memory several columns at a time, and
    c >= 128 keeps B3's factored table."""
    if n < 1 or n & (n - 1) or n > KERNEL_NTT_MAX:
        raise ValueError(f"no kernel NTT plan for n = {n}")
    if n <= SUB_MAX:
        return n, 1
    logn = n.bit_length() - 1
    c = 1 << max(7, logn // 2)
    return n // c, c


def step_radices(m: int):
    """The radices of B2's Stockham steps for an m-point transform: the
    radix-2 or radix-4 remainder first (its twiddles are the fewest), then
    radix 8."""
    log_m = m.bit_length() - 1
    rem = log_m % 3
    return ([1 << rem] if rem else []) + [8] * (log_m // 3)


def step_table(m: int, root: int, device=None) -> torch.Tensor:
    """B2's between-step twiddles. The step of radix R that splits
    transforms of length n multiplies output j of butterfly p by
    w_n^(p·j) = root^((m/n)·p·j). The kernel computes its DFTs with the
    fixed root 2^24, so its register jr holds output j = jr / kappa mod R
    (`root_kappa`): the step's rows are in register order, jr = 1..R-1,
    n/R words each, one step after the other. The last step has none
    (p = 0); the table keeps one word so that it is never empty."""
    powers = f.powers(root, m)
    kinv = pow(root_kappa(m, root), -1, 8)
    chunks = []
    n = m
    for R in step_radices(m)[:-1]:
        p = torch.arange(n // R, dtype=torch.int64)
        j = (kinv * torch.arange(1, R, dtype=torch.int64)) % R
        chunks.append(powers[(m // n) * j[:, None] * p[None, :]].reshape(-1))
        n //= R
    table = torch.cat(chunks) if chunks else torch.ones(1, dtype=torch.int64)
    return transfer(table, device)


def root_kappa(m: int, root: int) -> int:
    """The odd kappa in 1..7 with root^(m/8) = 2^(24·kappa): in this field
    2^96 = -1, so the 8th roots of unity are the powers of 2^24, and B2's
    in-register DFTs multiply by shifts. Which primitive 8th root the
    plan's sub-root gives is the plan's to say. For m = 4 the same with
    root = 2^(48·kappa); for m = 2, 1."""
    if m <= 2:
        return 1
    order = min(m, 8)
    w = f.h_pow(root, m // order)
    for kappa in range(1, order, 2):
        if f.h_pow(2, 192 // order * kappa) == w:
            return kappa
    raise ValueError(f"{root} is not a primitive {m}-th root of unity")


def tile_shape(m: int, strided: bool) -> Tuple[int, int]:
    """(log_ti, log_vo) of B2's launch for m-point vectors: 2^log_ti
    adjacent vectors interleaved in one group (more than one only where
    `strided`: a vector's elements are not adjacent in memory, its
    neighbours' are), 2^log_vo groups a block."""
    log_m = m.bit_length() - 1
    log_ti = max(0, min(LOG_TI_STRIDED, MAX_LOG_TILE - log_m)) if strided else 0
    log_vo = max(0, min(LOG_TILE, MAX_LOG_TILE) - log_m - log_ti,
                 6 - log_m - log_ti)
    return log_ti, log_vo


def twiddle_values(rows: int, cols: int, root: int, row_stride: int = 1,
                   device=None) -> torch.Tensor:
    """(rows, cols) table of root^(row_stride·b·j), built on the host (the
    u64 values behind the JAX package's `limb.twiddle_values`)."""
    ratios = torch.tensor(
        [to_i64(f.h_pow(root, row_stride * b)) for b in range(rows)],
        dtype=torch.int64,
    )
    table = f.geometric_rows(torch.ones_like(ratios), ratios, cols)
    return transfer(table, device)


def outer_tables(n: int, r: int, root: int, device=None):
    """B3's factored (c, r) table w^(b·j), b = 128·b_hi + b_lo: the hi rows
    (c // 128, r) and the lo rows (128, r)."""
    c = n // r
    return (twiddle_values(c // 128, r, root, 128, device),
            twiddle_values(128, r, root, 1, device))


def _sub_plan(m: int, root: int, scale: int, device) -> SubPlan:
    return SubPlan(m, make_network_pack(m, root, False, device), scale,
                   step_table(m, root, device), root_kappa(m, root))


def make_kernel_plan(n: int, root: int, inverse: bool = False,
                     device=None) -> KernelNttPlan:
    """Tables for an n-point forward (or inverse, scaled by n^-1) NTT with
    `root`, on `device`. Plans are kept per (n, root, inverse, device): a
    prover is built for every job and asks for the same few plans (its
    tables' INTTs, its LDE or class transform), and their tables are only
    ever read. A CUDA device without an index is the current one."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return _kernel_plan(n, root, bool(inverse), device)


@lru_cache(maxsize=64)
def _kernel_plan(n: int, root: int, inverse: bool, device) -> KernelNttPlan:
    w = f.h_inverse(root) if inverse else root
    scale = f.h_inverse(n % f.P) if inverse else 1
    r, c = plan_geometry(n)
    if c == 1:
        return KernelNttPlan(n, n, 1, _sub_plan(n, w, scale, device),
                             None, None, None)
    tw_hi, tw_lo = outer_tables(n, r, w, device)
    return KernelNttPlan(
        n, r, c,
        _sub_plan(r, f.h_pow(w, c), scale, device),
        _sub_plan(c, f.h_pow(w, r), 1, device),
        tw_hi, tw_lo,
    )


# ---------------------------------------------------------------------------
# plain torch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


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


def make_network_pack(n: int, root: int, inverse: bool = False,
                      device=None) -> TwiddlePack:
    """The radix-2 network's tables for a size-n transform with `root` (or
    its inverse, scaled by n^-1), on `device`."""
    n_inv = None
    if inverse:
        n_inv = transfer(torch.tensor(to_i64(f.h_inverse(n % f.P)),
                                      dtype=torch.int64), device)
    r = f.h_inverse(root) if inverse else root
    return TwiddlePack(
        perm=transfer(_bitrev_permutation(n), device),
        stages=tuple(transfer(s, device) for s in _stage_twiddles(n, r)),
        n_inv=n_inv,
    )


def network_ntt(values, pack: TwiddlePack):
    """The iterative radix-2 butterfly network along the last axis, on the
    plain field operations on any device: out[k] = Σ_j v[j]·root^(jk),
    scaled by pack.n_inv where it is set. B2's plain version, and the
    yardstick of the composed transform."""
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
        t = f.mul_plain(odd, tw[None, None, :])
        x = torch.cat([f.add_plain(even, t), f.sub_plain(even, t)], dim=-1)
    x = x.reshape(shape)
    if pack.n_inv is not None:
        x = f.mul_plain(x, pack.n_inv)
    return x


def subntt_plain(x, sub: SubPlan):
    """The radix-2 network along each row, then the scale."""
    out = network_ntt(x, sub.pack)
    return out if sub.scale == 1 else f.mul_plain(out, f.const(sub.scale, out))


def _strided_view(flat, batches: int, nvec: int, m: int, st: Strides):
    return torch.as_strided(flat, (batches, nvec, m), tuple(st))


def subntt_tiled_plain(x, sub: SubPlan, batches: int, nvec: int,
                       src: Strides, dst: Strides):
    """`subntt_plain` of the vectors that `src` describes in x, written
    where `dst` says: two torch gathers around the radix-2 network."""
    rows = _strided_view(x.reshape(-1), batches, nvec, sub.m, src)
    res = subntt_plain(rows.reshape(-1, sub.m), sub)
    out = torch.empty_like(x)
    _strided_view(out.view(-1), batches, nvec, sub.m, dst).copy_(
        res.reshape(batches, nvec, sub.m))
    return out


def twiddle_outer_plain(y, plan: KernelNttPlan):
    """Row g, column j times w^((g mod c)·j): two field multiplies with the
    gathered lo and hi table rows."""
    b = torch.arange(y.shape[0], device=y.device) % plan.c
    return f.mul_plain(f.mul_plain(y, plan.tw_lo[b % 128]),
                       plan.tw_hi[b // 128])


# ---------------------------------------------------------------------------
# the Hopper kernels
# ---------------------------------------------------------------------------

_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("ntt")
        lib.subntt_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 4 + [ctypes.c_ulonglong]
            + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        )
        lib.twiddle_outer_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.subntt_launch.restype = ctypes.c_int
        lib.twiddle_outer_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _on_card(x, *tables):
    if not x.is_contiguous():
        raise ValueError("the NTT kernels take contiguous tensors")
    for t in tables:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"plan tables are not on {x.device}")


def _launch(fn, x, args, what: str):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def _launch_subntt(x, sub: SubPlan, batches: int, nvec: int, src: Strides,
                   dst: Strides):
    global LAUNCHES_SUBNTT
    _on_card(x, sub.table)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    log_ti, log_vo = tile_shape(sub.m, src.elem != 1 or dst.elem != 1)
    kinv = pow(sub.kappa, -1, 8)
    _launch(
        _kernel_lib().subntt_launch, x,
        (_ptr(x), _ptr(out), _ptr(sub.table), batches, nvec,
         sub.m.bit_length() - 1, log_ti, log_vo, kinv, sub.scale,
         *src, *dst),
        "subntt",
    )
    LAUNCHES_SUBNTT += 1
    return out


def _launch_twiddle(y, plan: KernelNttPlan):
    global LAUNCHES_TWIDDLE
    _on_card(y, plan.tw_hi, plan.tw_lo)
    out = torch.empty_like(y)
    rows = y.shape[0]
    if rows == 0:
        return out
    _launch(
        _kernel_lib().twiddle_outer_launch, y,
        (_ptr(y), _ptr(out), _ptr(plan.tw_hi), _ptr(plan.tw_lo), rows,
         plan.r.bit_length() - 1, plan.c.bit_length() - 1),
        "twiddle_outer",
    )
    LAUNCHES_TWIDDLE += 1
    return out


def _check(x, width: int, what: str):
    if x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != width:
        raise ValueError(f"{what} takes a 2-D int64 tensor of width {width}")


def subntt_tiled(x, sub: SubPlan, batches: int, nvec: int, src: Strides,
                 dst: Strides):
    """NTT of batches·nvec vectors of m words with the sub-plan's root,
    times its scale. x is a contiguous int64 tensor of batches·nvec·m
    words; `src` says where each vector lies in it and `dst` where its
    transform goes in the result, a new tensor of x's shape (every word of
    which `dst` must cover). A CUDA tensor runs kernel B2 (or raises); a CPU
    tensor runs `subntt_tiled_plain`."""
    if x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError("subntt_tiled takes a contiguous int64 tensor")
    if batches < 0 or nvec < 0 or x.numel() != batches * nvec * sub.m:
        raise ValueError(
            f"subntt_tiled: {x.numel()} words are not {batches} x {nvec} "
            f"vectors of {sub.m}")
    for st in (src, dst):
        last = ((batches - 1) * st.batch + (nvec - 1) * st.vec
                + (sub.m - 1) * st.elem)
        if min(st) < 0 or (x.numel() and last >= x.numel()):
            raise ValueError(f"subntt_tiled: {st} leaves the tensor")
    if x.is_cuda:
        return _launch_subntt(x, sub, batches, nvec, src, dst)
    if x.device.type == "cpu":
        return subntt_tiled_plain(x, sub, batches, nvec, src, dst)
    raise ValueError(f"no sub-NTT path for device {x.device}")


def subntt(x, sub: SubPlan):
    """NTT of each row of x (rows, m) int64 with the sub-plan's root, times
    its scale; a new tensor. A CUDA tensor runs kernel B2 (or raises); a CPU
    tensor runs `subntt_plain`."""
    _check(x, sub.m, "subntt")
    if x.is_cuda:
        rows = Strides(0, sub.m, 1)
        return subntt_tiled(x, sub, 1, x.shape[0], rows, rows)
    if x.device.type == "cpu":
        return subntt_plain(x, sub)
    raise ValueError(f"no sub-NTT path for device {x.device}")


def twiddle_outer(y, plan: KernelNttPlan):
    """y (B·c, r) int64 -> row g times w^((g mod c)·j) in column j; a new
    tensor. A CUDA tensor runs kernel B3 (or raises); a CPU tensor runs
    `twiddle_outer_plain`."""
    _check(y, plan.r, "twiddle_outer")
    if plan.c < 128 or y.shape[0] % plan.c:
        raise ValueError(f"twiddle_outer: {y.shape[0]} rows, c = {plan.c}")
    if y.is_cuda:
        return _launch_twiddle(y, plan)
    if y.device.type == "cpu":
        return twiddle_outer_plain(y, plan)
    raise ValueError(f"no outer-twiddle path for device {y.device}")


# ---------------------------------------------------------------------------
# full transform
# ---------------------------------------------------------------------------


def ntt_kernel(values, plan: KernelNttPlan):
    """int64 rows (..., n) -> (..., n): out[k] = Σ_j v[j]·root^(jk), scaled
    by n^-1 for inverse plans (the contract of the JAX package's
    `ops/ntt.ntt_with`). Every NTT of the port goes through here. A
    one-point transform is the identity (its n^-1 is 1): the input comes
    back, and no kernel is launched.

    With j = b·r + a and k = k1·c + k2, B2 transforms each row's (c, r)
    view down its columns (over b, root w^r), in place of layout: y[k2, a];
    B3 twiddles by w^(k2·a); B2 transforms the rows (over a, root w^c) and
    stores z[k2, k1] transposed, which is the output. The kernel reads and
    writes the strided views itself, a few adjacent columns a block: no
    torch copy of the block of rows is made."""
    n = values.shape[-1]
    if n != plan.n:
        raise ValueError(f"ntt_kernel: width {n}, plan for {plan.n}")
    if n == 1:
        return values
    shape = values.shape
    v = values.reshape(-1, n).contiguous()
    B = v.shape[0]
    if plan.sub_c is None:
        return subntt(v, plan.sub_r).reshape(shape)
    r, c = plan.r, plan.c
    columns = Strides(n, 1, r)
    y = subntt_tiled(v, plan.sub_c, B, r, columns, columns)
    y = twiddle_outer(y.view(B * c, r), plan)
    out = subntt_tiled(y, plan.sub_r, B, c, Strides(n, r, 1), Strides(n, 1, c))
    return out.reshape(shape)

