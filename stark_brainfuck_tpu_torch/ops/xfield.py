"""Cubic extension field F_{p^3} = F_p[X] / (X^3 - X + 1), on torch.

An extension element batch is an int64 tensor with trailing dim 3
(coefficients c0 + c1·X + c2·X^2, canonical < p), in the representation of
`field.py`. Multiplication is the unrolled 9-product schoolbook with the
closed-form reduction X^3 ≡ X - 1, X^4 ≡ X^2 - X; inversion is the adjugate
of the multiplication matrix plus one base-field inversion.

`mul` and `mul_base` take a CUDA tensor to kernel F2 (`field_kernels`,
`csrc/field.cu`: one thread an extension element, one launch) and a CPU
tensor to `mul_plain` and `mul_base_plain`, the torch form over the plain
base-field operations; `add` and `sub` are `field.add` and `field.sub` over
the coefficient words (kernel F1 on a CUDA tensor).
"""

from __future__ import annotations

import torch

from ..convert import to_i64
from ..utils.metrics import transfer
from . import field as f
from . import field_kernels as fk
from .field import P


def from_base(a):
    """Lift base-field tensor (...,) -> extension tensor (..., 3)."""
    z = torch.zeros(a.shape + (2,), dtype=torch.int64, device=a.device)
    return torch.cat([a[..., None], z], dim=-1)


def scalar(c0: int, c1: int = 0, c2: int = 0, device=None):
    return transfer(torch.tensor(
        [to_i64(c0 % P), to_i64(c1 % P), to_i64(c2 % P)], dtype=torch.int64,
    ), device)


def zeros(shape, device=None):
    return torch.zeros(tuple(shape) + (3,), dtype=torch.int64, device=device)


def ones(shape, device=None):
    z = zeros(shape, device)
    z[..., 0] = 1
    return z


def add(a, b):
    return f.add(a, b)


def sub(a, b):
    return f.sub(a, b)


def mul(a, b):
    """a · b in F_p^3, broadcast over the leading axes."""
    device = fk.card_device(a, b)
    if device is not None:
        return fk.xf_binary(fk.XMUL, a, b, device)
    return mul_plain(a, b)


def mul_base(a, b):
    """Extension (...,3) times base (...,) — 3 base muls instead of 9."""
    device = fk.card_device(a, b)
    if device is not None:
        return fk.xf_binary(fk.XMUL_BASE, a, b, device)
    return mul_base_plain(a, b)


def mul_plain(a, b):
    """`mul` as torch ops: the schoolbook product, then reduce by
    X^3 = X - 1."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    m, ad, sb = f.mul_plain, f.add_plain, f.sub_plain

    c0 = m(a0, b0)
    c1 = ad(m(a0, b1), m(a1, b0))
    c2 = ad(ad(m(a0, b2), m(a1, b1)), m(a2, b0))
    c3 = ad(m(a1, b2), m(a2, b1))
    c4 = m(a2, b2)

    # X^3 ≡ X - 1  => c3·X^3 = -c3 + c3·X
    # X^4 ≡ X^2 - X => c4·X^4 = -c4·X + c4·X^2
    r0 = sb(c0, c3)
    r1 = sb(ad(c1, c3), c4)
    r2 = ad(c2, c4)
    return torch.stack([r0, r1, r2], dim=-1)


def mul_base_plain(a, b):
    """`mul_base` as torch ops."""
    return f.mul_plain(a, b[..., None])


def pow_const(a, exponent: int):
    if exponent == 0:
        return ones(a.shape[:-1], a.device)
    acc = None
    for bit in bin(exponent)[2:]:
        if acc is not None:
            acc = mul(acc, acc)
        if bit == "1":
            acc = a if acc is None else mul(acc, a)
    return acc


def inverse(a):
    """Closed-form inverse via the adjugate of the multiplication-by-a
    matrix M = [[a0, -a2, -a1], [a1, a0+a2, a1-a2], [a2, a1, a0+a2]]:
    a^{-1} = adj(M)·e0 / det(M)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    m, ad, sb = f.mul, f.add, f.sub

    s = ad(a0, a2)
    t = sb(a1, a2)
    adj0 = sb(m(s, s), m(t, a1))
    adj1 = sb(m(t, a2), m(a1, s))
    adj2 = sb(m(a1, a1), m(s, a2))
    det = sb(sb(m(a0, adj0), m(a2, adj1)), m(a1, adj2))
    det_inv = f.inverse(det)
    return torch.stack(
        [m(adj0, det_inv), m(adj1, det_inv), m(adj2, det_inv)], dim=-1
    )


# ---------------------------------------------------------------------------
# host-side scalar helpers (3-tuples of python ints)
# ---------------------------------------------------------------------------

H_ZERO = (0, 0, 0)
H_ONE = (1, 0, 0)


def h_from_base(v: int):
    return (v % P, 0, 0)


def h_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P, (a[2] + b[2]) % P)


def h_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P, (a[2] - b[2]) % P)


def h_neg(a):
    return ((-a[0]) % P, (-a[1]) % P, (-a[2]) % P)


def h_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    c0 = a0 * b0
    c1 = a0 * b1 + a1 * b0
    c2 = a0 * b2 + a1 * b1 + a2 * b0
    c3 = a1 * b2 + a2 * b1
    c4 = a2 * b2
    return ((c0 - c3) % P, (c1 + c3 - c4) % P, (c2 + c4) % P)


def h_pow(a, e: int):
    acc = H_ONE
    base = a
    while e:
        if e & 1:
            acc = h_mul(acc, base)
        base = h_mul(base, base)
        e >>= 1
    return acc


def h_inverse(a):
    a0, a1, a2 = a
    s = (a0 + a2) % P
    t = (a1 - a2) % P
    adj0 = (s * s - t * a1) % P
    adj1 = (t * a2 - a1 * s) % P
    adj2 = (a1 * a1 - s * a2) % P
    det = (a0 * adj0 - a2 * adj1 - a1 * adj2) % P
    det_inv = pow(det, P - 2, P)
    return (adj0 * det_inv % P, adj1 * det_inv % P, adj2 * det_inv % P)


def h_sample(byte_array: bytes):
    """Hash-to-extension-field: split bytes into 3 chunks, each mod p."""
    chunk = len(byte_array) // 3
    return tuple(
        f.sample_bytes(byte_array[i * chunk : (i + 1) * chunk]) for i in range(3)
    )
