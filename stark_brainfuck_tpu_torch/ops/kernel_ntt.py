"""Four-step Goldilocks NTT on kernels B2 and B3 (`ntt_backend="mxu"`).

The counterpart of the JAX package's `ops/pallas_ntt.py`: the same plan
geometry (`make_pallas_plan`) and the same four-step order (`ntt_pallas`),
bit-identical to the u64 butterfly network of `ops/ntt.py`.

The representation differs. The TPU kernels hold each element as 9
balanced int8 limbs, plane-major, so that the radix-128/64 DFTs run as int8
matrix products on the MXU and twiddles are limb convolutions
(`ops/limb.py`, `ops/mxu_ntt.py`). Hopper multiplies 64-bit words natively,
so the port's kernels take the canonical u64 words (int64 tensors, as
everywhere in the port) and run radix-2 butterflies in shared memory; the
limb modules have no counterpart here.

  - `subntt` (B2, `csrc/ntt.cu` `subntt_kernel`): an NTT of m <= 2^13
    points along each row;
  - `twiddle_outer` (B3, `twiddle_outer_kernel`): row g, column j times
    w^((g mod c)·j) from the factored hi/lo tables;
  - `ntt_kernel`: the full n-point transform (n <= 2^26) composed of them.

A wrapper given a CUDA tensor launches its kernel (or raises); given a CPU
tensor it runs its plain torch version (`subntt_plain`,
`twiddle_outer_plain`); any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..convert import to_i64
from . import cuda_build
from . import field as f
from . import ntt as nt

SUB_MAX = 1 << 13  # largest sub-transform: 64 KB of u64 words in shared memory
KERNEL_NTT_MAX = 1 << 26  # n = r·c with r, c <= SUB_MAX

# launches of each CUDA kernel since import (or since a caller reset them)
LAUNCHES_SUBNTT = 0
LAUNCHES_TWIDDLE = 0


class SubPlan(NamedTuple):
    """One m-point sub-transform: the radix-2 tables of `ops/ntt.py` (the
    plain version's; the last stage's table, the m/2 powers of the
    sub-root, is the kernel's) and the factor applied to every output."""

    m: int
    pack: nt.TwiddlePack
    scale: int  # 1, or n^-1 for the last sub-NTT of an inverse plan

    @property
    def twiddles(self) -> torch.Tensor:
        return self.pack.stages[-1]


class KernelNttPlan(NamedTuple):
    n: int
    r: int  # n = r·c; c == 1 for a single sub-transform
    c: int
    sub_r: SubPlan
    sub_c: Optional[SubPlan]
    tw_hi: Optional[torch.Tensor]  # (c // 128, r): w^(128·b_hi·j)
    tw_lo: Optional[torch.Tensor]  # (128, r): w^(b_lo·j)


def plan_geometry(n: int) -> Tuple[int, int]:
    """(r, c) of `make_pallas_plan`: one sub-transform up to 2^13 points,
    else r = 2^min(13, log n - 7) and c = n / r (a multiple of 128)."""
    assert n >= 2 and n & (n - 1) == 0 and n <= KERNEL_NTT_MAX, n
    if n <= SUB_MAX:
        return n, 1
    logn = n.bit_length() - 1
    r = 1 << min(13, logn - 7)
    c = n // r
    assert c <= SUB_MAX and c % 128 == 0, (n, r, c)
    return r, c


def twiddle_values(rows: int, cols: int, root: int, row_stride: int = 1,
                   device=None) -> torch.Tensor:
    """(rows, cols) table of root^(row_stride·b·j), built on the host (the
    u64 values behind the JAX package's `limb.twiddle_values`)."""
    ratios = torch.tensor(
        [to_i64(f.h_pow(root, row_stride * b)) for b in range(rows)],
        dtype=torch.int64,
    )
    table = f.geometric_rows(torch.ones_like(ratios), ratios, cols)
    return table if device is None else table.to(device)


def outer_tables(n: int, r: int, root: int, device=None):
    """B3's factored (c, r) table w^(b·j), b = 128·b_hi + b_lo: the hi rows
    (c // 128, r) and the lo rows (128, r)."""
    c = n // r
    return (twiddle_values(c // 128, r, root, 128, device),
            twiddle_values(128, r, root, 1, device))


def _sub_plan(m: int, root: int, scale: int, device) -> SubPlan:
    return SubPlan(m, nt._make_small_pack(m, root, False, device), scale)


def make_kernel_plan(n: int, root: int, inverse: bool = False,
                     device=None) -> KernelNttPlan:
    """Tables for an n-point forward (or inverse, scaled by n^-1) NTT with
    `root`, on `device`."""
    w = f.h_inverse(root) if inverse else root
    scale = f.h_inverse(n % f.P) if inverse else 1
    r, c = plan_geometry(n)
    if c == 1:
        return KernelNttPlan(n, n, 1, _sub_plan(n, w, scale, device),
                             None, None, None)
    tw_hi, tw_lo = outer_tables(n, r, w, device)
    return KernelNttPlan(
        n, r, c,
        _sub_plan(r, f.h_pow(w, c), 1, device),
        _sub_plan(c, f.h_pow(w, r), scale, device),
        tw_hi, tw_lo,
    )


# ---------------------------------------------------------------------------
# plain torch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def subntt_plain(x, sub: SubPlan):
    """The radix-2 network of `ops/ntt.py` along each row, then the scale."""
    out = nt.ntt_with(x, sub.pack)
    return out if sub.scale == 1 else f.mul(out, f.const(sub.scale, out))


def twiddle_outer_plain(y, plan: KernelNttPlan):
    """Row g, column j times w^((g mod c)·j): two field multiplies with the
    gathered lo and hi table rows."""
    b = torch.arange(y.shape[0], device=y.device) % plan.c
    return f.mul(f.mul(y, plan.tw_lo[b % 128]), plan.tw_hi[b // 128])


# ---------------------------------------------------------------------------
# the Hopper kernels
# ---------------------------------------------------------------------------

_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("ntt")
        lib.subntt_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
            ctypes.c_void_p,
        ]
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


def _launch_subntt(x, sub: SubPlan):
    global LAUNCHES_SUBNTT
    _on_card(x, sub.twiddles)
    out = torch.empty_like(x)
    rows = x.shape[0]
    if rows == 0:
        return out
    _launch(
        _kernel_lib().subntt_launch, x,
        (_ptr(x), _ptr(out), _ptr(sub.twiddles), rows,
         sub.m.bit_length() - 1, sub.scale),
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


def subntt(x, sub: SubPlan):
    """NTT of each row of x (rows, m) int64 with the sub-plan's root, times
    its scale; a new tensor. A CUDA tensor runs kernel B2 (or raises); a CPU
    tensor runs `subntt_plain`."""
    _check(x, sub.m, "subntt")
    if x.is_cuda:
        return _launch_subntt(x, sub)
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
    by n^-1 for inverse plans (the contract of `ops/ntt.ntt_with`).

    With j = a·c + b the rows are transposed to (B·c, r), transformed over
    a with root w^c (B2), twiddled by w^(b·k1) (B3), transposed to (B·r, c)
    and transformed over b with root w^r (B2); out[k1 + r·k2] is read back
    by a last transpose. The transposes are torch copies."""
    n = values.shape[-1]
    assert n == plan.n, (n, plan.n)
    shape = values.shape
    v = values.reshape(-1, n)
    B = v.shape[0]
    if plan.sub_c is None:
        return subntt(v.contiguous(), plan.sub_r).reshape(shape)
    r, c = plan.r, plan.c
    y = v.reshape(B, r, c).transpose(1, 2).contiguous().reshape(B * c, r)
    y = subntt(y, plan.sub_r)
    y = twiddle_outer(y, plan)
    z = y.reshape(B, c, r).transpose(1, 2).contiguous().reshape(B * r, c)
    del y
    z = subntt(z, plan.sub_c)
    out = z.reshape(B, r, c).transpose(1, 2).contiguous()
    return out.reshape(shape)
