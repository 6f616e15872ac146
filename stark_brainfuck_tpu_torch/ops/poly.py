"""Host-side univariate polynomial utilities over F_p (python ints).

Completes the reference's L2 polynomial layer (`univariate.py:4-194`) for
the places where scalar polynomial algebra is genuinely host work: tiny
last-codeword checks, test oracles, degree bookkeeping. The prover's
codeword-scale polynomial work happens in `ntt.py` as array kernels — this
module is deliberately small and scalar.

Coefficients are dense lists of python ints (mod p), lowest degree first,
like the reference. A copy of the JAX package's `ops/poly.py`: host code on
python ints, with no tensor in it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .field import P, h_inverse


def degree(coeffs: Sequence[int]) -> int:
    for i in range(len(coeffs) - 1, -1, -1):
        if coeffs[i] % P:
            return i
    return -1


def trim(coeffs: Sequence[int]) -> List[int]:
    return list(coeffs[: degree(coeffs) + 1])


def add(a: Sequence[int], b: Sequence[int]) -> List[int]:
    n = max(len(a), len(b))
    return [
        ((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % P
        for i in range(n)
    ]


def neg(a: Sequence[int]) -> List[int]:
    return [(-c) % P for c in a]


def sub(a: Sequence[int], b: Sequence[int]) -> List[int]:
    return add(a, neg(b))


def mul(a: Sequence[int], b: Sequence[int]) -> List[int]:
    """Schoolbook product (host scale; ref univariate.py:46-55)."""
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, ca in enumerate(a):
        if ca == 0:
            continue
        for j, cb in enumerate(b):
            out[i + j] = (out[i + j] + ca * cb) % P
    return out


def scalar_mul(a: Sequence[int], s: int) -> List[int]:
    return [c * s % P for c in a]


def divide(num: Sequence[int], den: Sequence[int]) -> Tuple[List[int], List[int]]:
    """Long division with remainder (ref univariate.py:57-78)."""
    dn = degree(num)
    dd = degree(den)
    assert dd >= 0, "division by zero polynomial"
    if dn < dd:
        return [], trim(num)
    rem = list(num[: dn + 1])
    quot = [0] * (dn - dd + 1)
    inv_lead = h_inverse(den[dd] % P)
    for shift in range(dn - dd, -1, -1):
        coeff = rem[dd + shift] * inv_lead % P
        quot[shift] = coeff
        if coeff:
            for i in range(dd + 1):
                rem[i + shift] = (rem[i + shift] - coeff * den[i]) % P
    return quot, trim(rem)


def evaluate(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def evaluate_domain(coeffs: Sequence[int], xs: Sequence[int]) -> List[int]:
    return [evaluate(coeffs, x) for x in xs]


def interpolate(xs: Sequence[int], ys: Sequence[int]) -> List[int]:
    """Lagrange interpolation (host scale; ref univariate.py:119-135)."""
    assert len(xs) == len(ys)
    acc: List[int] = []
    for i in range(len(xs)):
        num = [1]
        den = 1
        for j in range(len(xs)):
            if i == j:
                continue
            num = mul(num, [(-xs[j]) % P, 1])
            den = den * (xs[i] - xs[j]) % P
        acc = add(acc, scalar_mul(num, ys[i] * h_inverse(den) % P))
    return trim(acc)


def zerofier(xs: Sequence[int]) -> List[int]:
    """Π (X - x_i) (ref univariate.py:137-143)."""
    acc = [1]
    for x in xs:
        acc = mul(acc, [(-x) % P, 1])
    return acc


def xgcd(a: Sequence[int], b: Sequence[int]):
    """Extended Euclid for polynomials (ref univariate.py:171-187).
    Returns (s, t, g) with s·a + t·b = g."""
    old_r, r = trim(a), trim(b)
    old_s, s = [1], []
    old_t, t = [], [1]
    while degree(r) >= 0:
        q, _ = divide(old_r, r)
        old_r, r = r, trim(sub(old_r, mul(q, r)))
        old_s, s = s, trim(sub(old_s, mul(q, s)))
        old_t, t = t, trim(sub(old_t, mul(q, t)))
    return old_s, old_t, old_r


def test_colinearity(points: Sequence[Tuple[int, int]]) -> bool:
    """Degree-<=1 check through the points (ref univariate.py:190-194)."""
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    return degree(interpolate(xs, ys)) <= 1
