"""Goldilocks base-field arithmetic over p = 2^64 - 2^32 + 1, on torch.

A field element batch is an int64 tensor holding the bits of the canonical
u64 value (< p). Torch has no usable u64 arithmetic, so the limb code of the
JAX package's `ops/field.py` is written here over int64 with three rules:

  - wrapping `+`, `-` and `*` give the same bits as u64 arithmetic;
  - a logical right shift is an arithmetic shift followed by a mask;
  - an unsigned compare flips the sign bit of both sides first.

Constants of 2^63 or more (p itself) appear as their signed equivalents.
Multiplication builds the exact 128-bit product from 32-bit halves and folds
it with 2^64 ≡ 2^32 - 1 (mod p), as in the reference.

`add`, `sub` and `mul` take a CUDA tensor to kernel F1 (`field_kernels`,
`csrc/field.cu`: one launch and one pass over the operands, where the torch
form below is 10 to 47 int64 ops) and a CPU tensor to `add_plain`,
`sub_plain` and `mul_plain`, that torch form. The plain versions run on any
device when called by name; the kernel is held to them bit for bit.
"""

from __future__ import annotations

import torch

from ..convert import to_i64
from ..utils.metrics import transfer
from . import field_kernels as fk

P = 0xFFFFFFFF00000001  # 2^64 - 2^32 + 1
M32 = 0xFFFFFFFF  # 2^32 - 1 == 2^64 - p (the folding constant)
GENERATOR = 7
ROOT_OF_UNITY_2_32 = 1753635133440165772
MAX_ORDER_LOG2 = 32

P_I64 = to_i64(P)  # -(2^32 - 1)
_SIGN = -(1 << 63)
_P_FLIPPED = P - (1 << 63)  # p with its sign bit flipped, as int64


def _ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _ge_p(x):
    """Unsigned x >= p."""
    return (x ^ _SIGN) >= _P_FLIPPED


def _hi32(x):
    """Logical x >> 32."""
    return (x >> 32) & M32


def const(v: int, like: torch.Tensor) -> torch.Tensor:
    """Scalar field constant on the device of `like`."""
    return transfer(torch.tensor(to_i64(v % P), dtype=torch.int64),
                    like.device)


def add(a, b):
    """(a + b) mod p, canonical inputs -> canonical output; broadcast."""
    device = fk.card_device(a, b)
    if device is not None:
        return fk.gl_binary(fk.ADD, a, b, device)
    return add_plain(a, b)


def sub(a, b):
    """(a - b) mod p, canonical inputs -> canonical output; broadcast."""
    device = fk.card_device(a, b)
    if device is not None:
        return fk.gl_binary(fk.SUB, a, b, device)
    return sub_plain(a, b)


def mul(a, b):
    """(a · b) mod p, canonical output; broadcast."""
    device = fk.card_device(a, b)
    if device is not None:
        return fk.gl_binary(fk.MUL, a, b, device)
    return mul_plain(a, b)


def add_plain(a, b):
    """`add` as int64 torch ops."""
    s = a + b
    # wrapped iff s < a (unsigned); true sum = s + 2^64 ≡ s + (2^32 - 1)
    s = torch.where(_ult(s, a), s + M32, s)
    return torch.where(_ge_p(s), s - P_I64, s)


def sub_plain(a, b):
    """`sub` as int64 torch ops."""
    d = a - b
    # borrowed iff a < b; wrapped d = a-b+2^64, want a-b+p = d - (2^32-1)
    return torch.where(_ult(a, b), d - M32, d)


def neg(a):
    return torch.where(a == 0, a, P_I64 - a)


def reduce128(hi, lo):
    """Reduce a 128-bit value hi·2^64 + lo into [0, p)."""
    hh = _hi32(hi)
    hl = hi & M32
    # t0 = lo - hh (mod p); hh < 2^32 so one correction suffices
    t0 = lo - hh
    t0 = torch.where(_ult(lo, hh), t0 - M32, t0)
    # t1 = hl·(2^32 - 1) < 2^64
    t1 = hl * M32
    r = t0 + t1
    r = torch.where(_ult(r, t1), r + M32, r)
    return torch.where(_ge_p(r), r - P_I64, r)


def mul_plain(a, b):
    """`mul` as int64 torch ops: the exact 128-bit product from 32-bit
    halves, then `reduce128`."""
    al = a & M32
    ah = _hi32(a)
    bl = b & M32
    bh = _hi32(b)
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    # middle column with carries: t <= 3·(2^32-1) stays positive
    t = _hi32(ll) + (lh & M32) + (hl & M32)
    lo = (ll & M32) | (t << 32)
    hi = hh + _hi32(lh) + _hi32(hl) + (t >> 32)
    return reduce128(hi, lo)


def pow_const(a, exponent: int):
    """a^exponent for a Python-int exponent (square-and-multiply)."""
    if exponent == 0:
        return torch.ones_like(a)
    acc = None
    for bit in bin(exponent)[2:]:
        if acc is not None:
            acc = mul(acc, acc)
        if bit == "1":
            acc = a if acc is None else mul(acc, a)
    return acc


def inverse(a):
    """a^(p-2), elementwise. 0 maps to 0."""
    return pow_const(a, P - 2)


def batch_inverse(a):
    """Vectorized inversion of a tensor with no zeros (fixed pow ladder,
    no data-dependent control flow, as in the reference)."""
    return inverse(a)


def from_u64_mod_p(words):
    """u64 words -> words mod p; since a word < 2^64 < 2p, one conditional
    subtract is the whole reduction."""
    return torch.where(_ge_p(words), words - P_I64, words)


# ---------------------------------------------------------------------------
# host-side scalar helpers (python ints)
# ---------------------------------------------------------------------------


def h_add(a: int, b: int) -> int:
    return (a + b) % P


def h_sub(a: int, b: int) -> int:
    return (a - b) % P


def h_mul(a: int, b: int) -> int:
    return (a * b) % P


def h_inverse(a: int) -> int:
    return pow(a, P - 2, P)


def h_pow(a: int, e: int) -> int:
    return pow(a, e, P)


def primitive_nth_root(n: int) -> int:
    """Primitive n-th root of unity, n a power of two <= 2^32."""
    assert n <= (1 << MAX_ORDER_LOG2) and (n & (n - 1)) == 0, (
        "field only has power-of-two roots of order <= 2^32"
    )
    root = ROOT_OF_UNITY_2_32
    order = 1 << MAX_ORDER_LOG2
    while order != n:
        root = h_mul(root, root)
        order //= 2
    return root


def sample_bytes(byte_array: bytes) -> int:
    """Hash-to-field: big-endian bytes -> int mod p."""
    acc = 0
    for b in byte_array:
        acc = (acc << 8) ^ b
    return acc % P


def geometric_rows(starts, ratios, count: int, mul_fn=None):
    """Given (c,) tensors `starts` and `ratios`, the (c, count) tensor
    out[i, j] = starts[i] · ratios[i]^j, by log-depth doubling with
    `mul_fn` (`mul` by default)."""
    mul_fn = mul_fn or mul
    c = starts.shape[0]
    if count <= 0:
        return torch.zeros((c, 0), dtype=torch.int64, device=starts.device)
    out = starts[:, None]
    factor = ratios  # ratios^length, length = current column count
    length = 1
    while length < count:
        take = min(length, count - length)
        out = torch.cat([out, mul_fn(out[:, :take], factor[:, None])], dim=1)
        length += take
        if length < count:
            factor = mul_fn(factor, factor)
    return out


def powers(base: int, count: int, device=None):
    """[1, base, base^2, ..., base^(count-1)] as an int64 tensor (log-depth
    doubling: each step appends prev · base^len(prev))."""
    if count <= 0:
        return torch.zeros((0,), dtype=torch.int64, device=device)
    out = torch.ones((1,), dtype=torch.int64, device=device)
    length = 1
    b = base % P
    while length < count:
        take = min(length, count - length)
        factor = transfer(
            torch.tensor(to_i64(h_pow(b, length)), dtype=torch.int64), device
        )
        out = torch.cat([out, mul(out[:take], factor)])
        length += take
    return out
