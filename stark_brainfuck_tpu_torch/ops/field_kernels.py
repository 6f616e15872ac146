"""The field layer's Hopper kernels (`csrc/field.cu`): F1, F2 and F3.

  - F1 `gl_binary`: Goldilocks add, sub and mul, elementwise, for
    `field.add/sub/mul` (and `xfield.add/sub`, which are F1 over the
    coefficient words);
  - F2 `xf_binary`: F_p^3 mul and mul_base, for `xfield.mul/mul_base`;
  - F3 `acc_group`: the weighted accumulation of the combination, for
    `protocol/stark.py` `_acc_group`, on power tables of its own launch;
    a group's columns are read where they lie (`acc_columns`).

The public names in `field.py`, `xfield.py` and `stark.py` call
`card_device` first: operands on a CUDA device come here and launch a
kernel (or raise), operands on the CPU take the plain torch versions beside
those names. The library is built by `cuda_build` at first use and bound
with ctypes; nothing here runs at import. Operands are int64 tensors with
the u64 bits of field elements (`convert.py`), broadcast and strided as the
call sites give them: F1 and F2 read them where they lie (strides of the
broadcast shape, 0 on a broadcast axis) and return a new contiguous tensor.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.metrics import transfer
from . import cuda_build

# launches of F1, F2 and F3 since import (or since a caller reset them);
# each F3 launch comes after a launch of its power tables, counted beside it
LAUNCHES_ELEMENTWISE = 0
LAUNCHES_XFIELD = 0
LAUNCHES_ACC = 0
LAUNCHES_ACC_POWERS = 0

# op codes of csrc/field.cu
ADD, SUB, MUL, XMUL, XMUL_BASE = 0, 1, 2, 3, 4

MAX_DIMS = 6  # csrc/field.cu kMaxDims
# csrc/field.cu's F3 constants: threads a block, log2 of the most term
# groups a block, terms a launch, and the power tables' split of a
# position i = (ACC_MID h + m) ACC_TILE + j
ACC_THREADS = 256
ACC_LOG_MAX_GROUPS = 3
ACC_MAX_TERMS = 64
ACC_TILE = 256
ACC_MID = 64
ACC_SPLIT_GAIN = 1.05

_LIB = None
_DIMS = ctypes.c_longlong * MAX_DIMS


def _kernel_lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("field")
        layout = ([ctypes.c_longlong, ctypes.c_int]
                  + [ctypes.POINTER(ctypes.c_longlong)] * 3)
        lib.gl_binary_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + layout
            + [ctypes.c_void_p])
        lib.xf_binary_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + layout
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        lib.acc_group_plan.argtypes = (
            [ctypes.c_int] + [ctypes.c_longlong] * 2
            + [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)])
        lib.acc_group_launch.argtypes = (
            [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_longlong] * 2 + [ctypes.c_int]
            + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
        for fn in (lib.gl_binary_launch, lib.xf_binary_launch,
                   lib.acc_group_plan, lib.acc_group_launch):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, device, *args):
    fn = getattr(_kernel_lib(), name)
    with torch.cuda.device(device):
        rc = fn(*args, ctypes.c_void_p(_stream(device)))
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError {rc}")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def card_device(*operands) -> Optional[torch.device]:
    """The CUDA device the operands go to a kernel on, or None when all lie
    on the CPU, where the plain torch version runs. Raises for any other
    device, for two CUDA devices, and for a CPU operand beside a CUDA one
    unless it is a 0-dim constant (the kernel wrappers move it)."""
    cuda = None
    for t in operands:
        kind = t.device.type
        if kind == "cuda":
            if cuda is not None and t.device != cuda:
                raise ValueError(f"operands on {cuda} and {t.device}")
            cuda = t.device
        elif kind != "cpu":
            raise ValueError(f"no field arithmetic for device {t.device}")
    if cuda is not None and any(t.device.type == "cpu" and t.dim()
                                for t in operands):
        raise ValueError(f"operands on the CPU and on {cuda}")
    return cuda


def _on(t, device):
    if t.dtype != torch.int64:
        raise ValueError(f"field kernels take int64 tensors, not {t.dtype}")
    return t if t.device == device else transfer(t, device)


def _broadcast_shape(*shapes) -> tuple:
    """`torch.broadcast_shapes`, without its cost on the launch path."""
    if all(s == shapes[0] for s in shapes):
        return tuple(shapes[0])
    nd = max(len(s) for s in shapes)
    out = []
    for d in range(-nd, 0):
        sizes = {s[d] for s in shapes if len(s) >= -d} - {1}
        if len(sizes) > 1:
            raise ValueError(f"shapes {[tuple(s) for s in shapes]} do not "
                             "broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out)


def _broadcast_strides(shape, tshape, tstride) -> List[int]:
    """Strides of a (tshape, tstride) tensor broadcast to `shape`."""
    lead = len(shape) - len(tshape)
    return [0] * lead + [0 if n == 1 else s for n, s in zip(tshape, tstride)]


def _layout(shape, operands: Sequence[Tuple[tuple, tuple]]):
    """(sizes, [strides of each operand]) of the broadcast space `shape`
    with size-1 axes dropped and each axis merged into the one before it
    where every operand's strides allow; None past MAX_DIMS axes."""
    strides = [_broadcast_strides(shape, s, st) for s, st in operands]
    sizes: List[int] = []
    merged: List[List[int]] = [[] for _ in operands]
    for d, n in enumerate(shape):
        if n == 1:
            continue
        if sizes and all(m[-1] == st[d] * n for m, st in zip(merged, strides)):
            sizes[-1] *= n
            for m, st in zip(merged, strides):
                m[-1] = st[d]
            continue
        sizes.append(n)
        for m, st in zip(merged, strides):
            m.append(st[d])
    if not sizes:
        return [1], [[0] for _ in operands]
    if len(sizes) > MAX_DIMS:
        return None
    return sizes, merged


def _dims(values) -> "ctypes.Array":
    return _DIMS(*values)


def gl_binary(op: int, a, b, device):
    """F1: a op b (ADD, SUB, MUL) on `device`, broadcast as torch does; a
    new contiguous int64 tensor."""
    global LAUNCHES_ELEMENTWISE
    a, b = _on(a, device), _on(b, device)
    shape = _broadcast_shape(a.shape, b.shape)
    lay = _layout(shape, [(a.shape, a.stride()), (b.shape, b.stride())])
    if lay is None:
        # more axes than the kernel splits: read contiguous copies
        a, b = a.expand(shape).contiguous(), b.expand(shape).contiguous()
        lay = [a.numel()], [[1], [1]]
    sizes, (sa, sb) = lay
    out = a.new_empty(shape)
    if out.numel() == 0:
        return out
    _launch("gl_binary_launch", device, op, _ptr(a), _ptr(b), _ptr(out),
            out.numel(), len(sizes), _dims(sizes), _dims(sa), _dims(sb))
    LAUNCHES_ELEMENTWISE += 1
    return out


def xf_binary(op: int, a, b, device):
    """F2: a (..., 3) times b, an extension (..., 3) for XMUL or a base
    (...) tensor for XMUL_BASE, on `device`, broadcast over the leading
    axes as `xfield.mul_plain` / `mul_base_plain` do; a new contiguous
    (..., 3) int64 tensor."""
    global LAUNCHES_XFIELD
    a, b = _on(a, device), _on(b, device)
    ext_b = op == XMUL
    for t in (a, b) if ext_b else (a,):
        if t.dim() == 0 or t.shape[-1] != 3:
            raise ValueError(f"an extension operand has shape {tuple(t.shape)}")
    b_elems = (tuple(b.shape[:-1]), b.stride()[:-1]) if ext_b else (
        tuple(b.shape), b.stride())
    shape = _broadcast_shape(a.shape[:-1], b_elems[0])
    lay = _layout(shape, [(tuple(a.shape[:-1]), a.stride()[:-1]), b_elems])
    if lay is None:
        a = a.expand(shape + (3,)).contiguous()
        b = (b.expand(shape + (3,)) if ext_b else b.expand(shape)).contiguous()
        lay = [a.numel() // 3], [[3], [3 if ext_b else 1]]
    sizes, (sa, sb) = lay
    out = a.new_empty(shape + (3,))
    if out.numel() == 0:
        return out
    _launch("xf_binary_launch", device, op, _ptr(a), _ptr(b), _ptr(out),
            out.numel() // 3, len(sizes), _dims(sizes), _dims(sa), _dims(sb),
            a.stride(-1), b.stride(-1) if ext_b else 0)
    LAUNCHES_XFIELD += 1
    return out


def acc_table_words(n: int) -> int:
    """Words of F3's power tables a term for n positions: r^j (j <
    ACC_TILE), r^(ACC_TILE m) (m < ACC_MID), start·r^(ACC_TILE ACC_MID h)."""
    return ACC_TILE + ACC_MID + -(-n // (ACC_TILE * ACC_MID))


def acc_geometry(terms: int, n: int, slots: int,
                 log_groups: Optional[int] = None) -> Tuple[int, int, int]:
    """(log2 G, positions a block, blocks) of an F3 launch, as
    csrc/field.cu `acc_group_plan` makes it for `slots` = SMs x blocks an SM
    holds: of G = 1, 2, 4, 8 (G <= T) term groups a block, the one that
    keeps most slots busy, blocks / (waves·slots) · T / (G·ceil(T / G)),
    where a larger G must beat the best smaller one by ACC_SPLIT_GAIN;
    `log_groups` forces it."""
    if log_groups is None:
        best, best_busy = 0, -1.0
        lg = 0
        while lg <= ACC_LOG_MAX_GROUPS and (1 << lg) <= terms:
            per, groups = ACC_THREADS >> lg, 1 << lg
            blocks = -(-n // per)
            waves = -(-blocks // slots)
            busy = (blocks / (waves * slots)
                    * terms / (groups * -(-terms // groups)))
            if busy > best_busy * ACC_SPLIT_GAIN:
                best, best_busy = lg, busy
            lg += 1
        log_groups = best
    per = ACC_THREADS >> log_groups
    return log_groups, per, -(-n // per)


def acc_plan(ext: bool, terms: int, n: int,
             log_groups: Optional[int] = None) -> dict:
    """The card's plan of an F3 launch (`acc_group_plan`): log2 of the term
    groups a block, positions a block, blocks, blocks an SM holds, SMs and
    registers a thread. Needs the card."""
    out = (ctypes.c_longlong * 6)()
    rc = _kernel_lib().acc_group_plan(
        int(ext), terms, n, -1 if log_groups is None else log_groups, out)
    if rc != 0:
        raise RuntimeError(f"acc_group_plan failed: cudaError {rc}")
    keys = ("log_groups", "positions_per_block", "blocks", "blocks_per_sm",
            "sms", "registers")
    return dict(zip(keys, out))


def acc_columns(parts) -> List[Tuple[torch.Tensor, int, int, int]]:
    """F3's terms of a group given as parts, (T, n) or (T, n, 3) tensors:
    for each term (the part it lies in, the offset of its first word from
    the part's, its position stride, its coefficient stride), in words."""
    cols = []
    for part in parts:
        st = part.stride()
        cs = st[2] if part.dim() == 3 else 0
        cols += [(part, k * st[0], st[1], cs) for k in range(part.shape[0])]
    return cols


def acc_group(acc, stack, w_pairs, ratios, starts, n: int,
              log_groups: Optional[int] = None):
    """F3: acc += Σ_t (w_pairs[t, 0] + w_pairs[t, 1]·starts[t]·ratios[t]^i)
    · stack[t, i] for i < n, the body of `BrainfuckStark._acc_group`.
    acc (n, 3); stack (T, n) base or (T, n, 3) extension terms at any
    strides, or a sequence of such parts, the group's terms in order (read
    where they lie: no concatenation); w_pairs (T, 2, 3); ratios, starts
    (T,); all int64 on one CUDA device. acc is updated in place (a
    contiguous copy of it first, if it is not contiguous) and returned.
    Groups of more than ACC_MAX_TERMS terms take several launches;
    `log_groups` forces the term split (`acc_geometry`)."""
    global LAUNCHES_ACC, LAUNCHES_ACC_POWERS
    parts = [stack] if isinstance(stack, torch.Tensor) else list(stack)
    device = card_device(acc, w_pairs, ratios, starts, *parts)
    if device is None:
        raise ValueError("acc_group launches on a CUDA device only")
    ext = bool(parts) and parts[0].dim() == 3
    if (not parts or any(q.dim() != (3 if ext else 2) or q.shape[1] != n
                         or (ext and q.shape[2] != 3) for q in parts)):
        raise ValueError(f"acc_group: stack {[tuple(q.shape) for q in parts]}"
                         f" for n = {n}")
    T = sum(int(q.shape[0]) for q in parts)
    if (tuple(acc.shape) != (n, 3) or tuple(w_pairs.shape) != (T, 2, 3)
            or tuple(ratios.shape) != (T,) or tuple(starts.shape) != (T,)):
        raise ValueError(
            f"acc_group: acc {tuple(acc.shape)}, w_pairs "
            f"{tuple(w_pairs.shape)}, ratios {tuple(ratios.shape)}, "
            f"starts {tuple(starts.shape)} for {T} terms of n = {n}")
    acc = _on(acc, device)
    if not acc.is_contiguous():
        acc = acc.contiguous()
    parts = [_on(q, device) for q in parts]
    w, r, s = (_on(t, device).contiguous() for t in (w_pairs, ratios, starts))
    if T == 0 or n == 0:
        return acc
    cols = acc_columns(parts)
    for lo in range(0, T, ACC_MAX_TERMS):
        chunk = cols[lo:lo + ACC_MAX_TERMS]
        k = len(chunk)
        flat = (ctypes.c_longlong * (3 * k))()
        for t, (q, off, st_i, st_c) in enumerate(chunk):
            flat[3 * t:3 * t + 3] = [q.data_ptr() + 8 * off, st_i, st_c]
        tables = acc.new_empty((k, acc_table_words(n)))
        _launch("acc_group_launch", device, _ptr(acc), flat, k, n, int(ext),
                _ptr(w[lo:lo + k]), _ptr(r[lo:lo + k]), _ptr(s[lo:lo + k]),
                _ptr(tables), -1 if log_groups is None else log_groups)
        LAUNCHES_ACC_POWERS += 1
        LAUNCHES_ACC += 1
    return acc
