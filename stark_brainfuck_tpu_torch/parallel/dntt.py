"""Distributed four-step NTT over the ranks of a mesh.

The counterpart of the JAX package's `parallel/dntt.py`, same names. A
size-N NTT factored as N = R·C:

  1. local DFT_R along the row axis (root ω^C) of the rank's C/D columns,
  2. twiddle multiply by ω^{c·k1} (the rank's columns of the table),
  3. all-to-all transpose,
  4. local DFT_C (root ω^R) of the rank's R/D rows,
  5. transpose and all-to-all back to natural-order contiguous blocks.

Index math: with input x[j], j = r·C + c laid out as an (R, C) matrix with
columns split over the ranks, the output satisfies
    X[k1 + R·k2] = Σ_c ω^{c·k1} (ω^R)^{c·k2} · [DFT_R(x[:, c])](k1),
so after step 4 the natural-order output is the (C, R) row-major flatten,
split by rows: each rank ends with one contiguous block of the codeword.

Where JAX's `shard_map` hands each device its slice of replicated inputs
and `lax.all_to_all` mixes, here every rank cuts its own columns out of the
coefficient rows (which are trace-sized and replicated) and the two
transposes are `Mesh.all_to_all` calls. A rank holds only its C/D columns
of the twiddle matrix, never the N-word table, and no N-long row.

The two local DFTs run along the middle axis of the rank's (B, R, C/D) and
(B, C, R/D) blocks (`_dft_middle`) on kernel B2 (its plain version on the
CPU; R and C are at most 2^13 up to N = 2^26, so one launch each), which
reads and writes the transposed views through its own strides, so that no
torch transpose copy of the block is made around it. The twiddle step is a
field multiply by the local table; from 128 columns a rank up it runs on
kernel B3: the rank's column offset goes into the high factor of B3's
factored table (row b_hi holds w^((offset + 128·b_hi)·j)), and the kernel
is unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from ..convert import u64_to_tensor
from ..ops import field as f
from ..ops import kernel_ntt as kn
from ..ops import ntt as nt
from .mesh import Mesh


def _factor(n: int):
    """Split n = R·C with R, C as close as possible (both powers of two)."""
    logn = n.bit_length() - 1
    log_r = logn // 2
    return 1 << log_r, 1 << (logn - log_r)


class DnttTables(NamedTuple):
    """One rank's tables of an n-point distributed transform."""

    n: int
    R: int
    C: int
    pack_r: kn.KernelNttPlan  # the R-point DFT, one B2 sub-transform
    pack_c: kn.KernelNttPlan  # ... and the C-point DFT
    twiddle: Optional[torch.Tensor]  # (C/D, R): ω^(c·k1), the rank's columns
    twiddle_plan: Optional[kn.KernelNttPlan]  # B3's tables in its place


def divides(n: int, world: int) -> bool:
    """Whether `world` ranks can run the distributed transform of n points:
    the rank count must divide both factors."""
    R, C = _factor(n)
    return R % world == 0 and C % world == 0


def twiddle_columns(root: int, lo: int, hi: int, R: int, device=None):
    """Columns [lo, hi) of the twiddle matrix T[k1, c] = root^(c·k1),
    transposed: (hi - lo, R), row c is 1, w^c, w^2c, ..."""
    ratios = u64_to_tensor([f.h_pow(root, c) for c in range(lo, hi)])
    return f.geometric_rows(torch.ones_like(ratios), ratios, R).to(device)


def make_dntt_tables(n: int, root: int, mesh: Mesh,
                     device=None) -> DnttTables:
    """The rank's tables for the n-point transform with `root`, on `device`
    (the mesh's by default): both DFT plans, and the twiddles of the rank's
    own C/D columns (B3's offset tables from 128 columns up)."""
    device = mesh.device if device is None else device
    R, C = _factor(n)
    if not divides(n, mesh.world):
        raise ValueError(
            f"mesh size {mesh.world} must divide both NTT factors {R}x{C}"
        )
    if C > kn.SUB_MAX:
        raise ValueError(f"no distributed transform of factors {R}x{C}: a "
                         f"local DFT is one B2 launch, {kn.SUB_MAX} points")
    pack_r = kn.make_kernel_plan(R, f.h_pow(root, C), False, device)
    pack_c = kn.make_kernel_plan(C, f.h_pow(root, R), False, device)
    lo, hi = mesh.block(C)
    cl = hi - lo
    if cl < 128:
        return DnttTables(n, R, C, pack_r, pack_c,
                          twiddle_columns(root, lo, hi, R, device), None)
    # row b = 128·b_hi + b_lo of the rank's (cl, R) table is
    # w^((lo + b)·j): the column offset rides in the hi rows
    hi_ratios = u64_to_tensor(
        [f.h_pow(root, lo + 128 * b) for b in range(cl // 128)])
    tw_hi = f.geometric_rows(torch.ones_like(hi_ratios), hi_ratios, R)
    plan = kn.KernelNttPlan(
        R * cl, R, cl, None, None, tw_hi.to(device),
        kn.twiddle_values(128, R, root, 1, device),
    )
    return DnttTables(n, R, C, pack_r, pack_c, None, plan)


def _local_columns(groups: Sequence[torch.Tensor], R: int, C: int, lo: int,
                   cl: int):
    """The rank's columns [lo, lo + cl) of the (R, C) view of every
    coefficient row, zero past each row's own length: (B, R, cl)."""
    B = sum(int(g.shape[0]) for g in groups)
    dev = groups[0].device
    x = torch.zeros((B, R, cl), dtype=torch.int64, device=dev)
    pos = 0
    for g in groups:
        b, d = int(g.shape[0]), int(g.shape[1])
        if d > R * C:
            raise ValueError(f"{d} coefficients for a transform of {R * C}")
        rows = -(-d // C)
        g = nt._pad_to(g, rows * C).reshape(b, rows, C)
        x[pos : pos + b, :rows] = g[:, :, lo : lo + cl]
        pos += b
    return x


def _dft_middle(x: torch.Tensor, plan: kn.KernelNttPlan, transposed: bool):
    """DFT along axis 1 of the contiguous x (B, m, v): one B2 launch (the
    plan is one sub-transform) with the strides of both layouts. Returns
    (B, v, m) when `transposed`, else (B, m, v)."""
    B, m, v = (int(d) for d in x.shape)
    src = kn.Strides(m * v, 1, v)
    dst = kn.Strides(m * v, m, 1) if transposed else src
    out = kn.subntt_tiled(x, plan.sub_r, B, v, src, dst)
    return out.view(B, v, m) if transposed else out


def distributed_ntt_with(values: Union[torch.Tensor, Sequence[torch.Tensor]],
                         tables: DnttTables, mesh: Mesh):
    """NTT of int64 coefficient rows across the mesh with prebuilt tables.
    `values`: (B, d) rows, d <= N, or a sequence of such groups of different
    widths (stacked in order); rows are zero past d and every rank holds
    them whole. Returns the rank's block (B, N/D) of the natural-order
    transform."""
    groups = [values] if torch.is_tensor(values) else list(values)
    R, C, D = tables.R, tables.C, mesh.world
    lo, hi = mesh.block(C)
    cl = hi - lo
    x = _local_columns(groups, R, C, lo, cl)  # (B, R, cl)
    B = int(x.shape[0])
    # 1. DFT over rows, stored with R last: (B, cl, R)
    y = _dft_middle(x, tables.pack_r, transposed=True)
    # 2. twiddle by the rank's columns of T
    if tables.twiddle_plan is not None:
        y = kn.twiddle_outer(
            y.reshape(B * cl, R).contiguous(), tables.twiddle_plan
        ).reshape(B, cl, R)
    else:
        y = f.mul(y, tables.twiddle[None])
    # 3. global transpose: (B, cl, R) -> (B, C, R/D)
    y = mesh.all_to_all(y, split_dim=2, concat_dim=1)
    # 4. DFT over columns, in place of layout: (B, C, R/D)
    y = _dft_middle(y, tables.pack_c, transposed=False)
    # 5. back to natural order: (B, C, R/D) -> (B, cl, R), flatten
    y = mesh.all_to_all(y, split_dim=1, concat_dim=2)
    return y.reshape(B, cl * R)


def distributed_ntt(values, root: int, mesh: Mesh):
    """Convenience wrapper building the tables inline (tests, eager use)."""
    n = int(values.shape[1])
    tables = make_dntt_tables(n, root, mesh, values.device)
    return distributed_ntt_with(values, tables, mesh)


def distributed_coset_evaluate(coeffs, offset: int, root: int, length: int,
                               mesh: Mesh):
    """Sharded coset LDE evaluate: scale by offset powers, then the
    distributed transform of the (implicitly zero-padded) rows."""
    d = int(coeffs.shape[1])
    scaled = f.mul(coeffs, nt.scale_table(offset, d, coeffs.device))
    tables = make_dntt_tables(length, root, mesh, coeffs.device)
    return distributed_ntt_with(scaled, tables, mesh)
