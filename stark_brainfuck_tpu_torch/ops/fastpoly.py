"""Fast polynomial algorithms over arbitrary domains, on tensors.

The JAX package's `ops/fastpoly.py` (the reference's generic O(n log^2 n)
toolbox of ref ntt.py:45-235: NTT multiplication, product-tree zerofiers,
remainder-tree multipoint evaluation, divide-and-conquer interpolation,
coset division) on int64 tensors that hold u64 bits. Each product or
remainder tree level is ONE batched NTT over a (num_nodes, 2^k)
coefficient matrix (`ops/ntt.py` `ntt`, on the kernel plan of every
transform), so a level is one vectorised transform rather than num_nodes
recursive calls.

Like the JAX package's, these are utility and parity algorithms: the
protocol only evaluates and interpolates on subgroup cosets, where the
direct (I)NTT of `ops/ntt.py` is cheaper. Every function takes what numpy
turns into a u64 array, or an int64 tensor, and computes on `device`;
without one, on the tensor's own device, and a host array goes to the card
(raising without one), as everywhere in the port.
"""

from __future__ import annotations

import torch

from ..convert import u64_to_tensor
from . import field as f
from . import ntt as nt


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.int64, "field tensors are int64 with u64 bits"
        return x if device is None else x.to(device)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to compute on the CPU")
        device = "cuda"
    return u64_to_tensor(x, device)


def _pad_to(arr, length: int):
    """Cut or zero-pad the last axis to `length`."""
    cur = arr.shape[-1]
    if cur >= length:
        return arr[..., :length]
    return nt._pad_to(arr, length)


def _linear_leaves(pts):
    """(m, 2) coefficient rows of the leaves X - p_i."""
    return torch.stack([f.neg(pts), torch.ones_like(pts)], dim=1)


def fast_multiply(a, b, device=None):
    """Product of dense coefficient rows (lowest degree first; the last axis
    is the coefficient axis and may be batched) via one NTT of the next
    power-of-two length (ref ntt.py:45-79)."""
    a = _tensor(a, device)
    b = _tensor(b, a.device)
    la, lb = int(a.shape[-1]), int(b.shape[-1])
    if la == 0 or lb == 0:
        return torch.zeros(a.shape[:-1] + (0,), dtype=torch.int64,
                           device=a.device)
    m = _next_pow2(la + lb - 1)
    root = f.primitive_nth_root(m)
    fa = nt.ntt(_pad_to(a, m), root)
    fb = nt.ntt(_pad_to(b, m), root)
    prod = nt.intt(f.mul(fa, fb), root)
    return prod[..., : la + lb - 1]


def fast_zerofier(points, device=None):
    """Monic Z(X) = prod (X - p_i) as an (n+1,) tensor (ref ntt.py:82-98).
    Product tree, one batched NTT multiply per level: level k holds the
    (n/2^k, 2^k + 1) coefficient matrix of the subtree zerofiers."""
    points = _tensor(points, device)
    n = int(points.shape[0])
    if n == 0:
        return torch.ones((1,), dtype=torch.int64, device=points.device)
    m = _next_pow2(n)
    # leaves (X - p_i), padded with (X - 0) = X for the power-of-two tree:
    # padding with X multiplies the result by X^(m-n); strip at the end
    nodes = _linear_leaves(_pad_to(points, m))
    while nodes.shape[0] > 1:
        nodes = fast_multiply(nodes[0::2], nodes[1::2])
    z = nodes[0]
    if m > n:
        z = z[m - n :]  # divide by X^(m-n) (exact: padded roots are 0)
    return z[: n + 1]


def _poly_mod_batch(num, dens):
    """num: (B, L) polynomials; dens: (B, D) monic denominators (degree D-1
    each). Returns the (B, D-1) remainders: schoolbook long division
    vectorised over the batch axis."""
    L = int(num.shape[1])
    d = int(dens.shape[1]) - 1  # denominator degree (monic)
    if L <= d:
        return _pad_to(num, d)
    rem = num
    # eliminate leading coefficients from the top down; the lead coefficient
    # of a monic divisor is 1, so the quotient coefficient IS the current lead
    for k in range(L - 1, d - 1, -1):
        lead = rem[:, k]
        chunk = f.sub(rem[:, k - d : k], f.mul(dens[:, :d], lead[:, None]))
        rem = torch.cat([rem[:, : k - d], chunk, rem[:, k:]], dim=1)
    return rem[:, :d]


def fast_evaluate(coeffs, points, device=None):
    """Multipoint evaluation of one dense polynomial at arbitrary points
    (ref ntt.py:101-123). Remainder tree over the batched zerofier tree:
    each level halves every residual's degree with ONE vectorised
    long-division pass."""
    coeffs = _tensor(coeffs, device)
    points = _tensor(points, coeffs.device)
    dev = coeffs.device
    n = int(points.shape[0])
    if n == 0:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    m = _next_pow2(n)
    # zerofier tree, leaves up
    nodes = _linear_leaves(_pad_to(points, m))
    levels = [nodes]
    while nodes.shape[0] > 1:
        nodes = fast_multiply(nodes[0::2], nodes[1::2])
        levels.append(nodes)
    # remainder tree, root down
    rem = coeffs.reshape(1, -1)
    if rem.shape[1] == 0:
        rem = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    for lvl in range(len(levels) - 2, -1, -1):
        # child j gets parent j // 2
        rem = _poly_mod_batch(torch.repeat_interleave(rem, 2, dim=0),
                              levels[lvl])
    # rem: (m, 1), the remainder mod (X - p_i) = the value at p_i
    return rem[:n, 0]


def fast_interpolate(points, values, device=None):
    """Interpolation through arbitrary (points, values) pairs (ref
    ntt.py:126-161): f = Σ y_i · Z'(p_i)^-1 · Z(X)/(X - p_i), assembled
    bottom-up; level k combines sibling interpolants as
    f = f_L · Z_R + f_R · Z_L with one batched NTT multiply."""
    points = _tensor(points, device)
    values = _tensor(values, points.device)
    dev = points.device
    n = int(points.shape[0])
    if n == 0:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    # weights w_i = 1 / Z'(p_i) = 1 / prod_{j != i} (p_i - p_j): the
    # zerofier's derivative at the points, through the remainder tree (the
    # derivative's factors 1..n are below p: the JAX package's `% P` is the
    # one conditional subtract of `from_u64_mod_p`)
    z = fast_zerofier(points)
    ks = f.from_u64_mod_p(torch.arange(1, n + 1, dtype=torch.int64,
                                       device=dev))
    w = f.batch_inverse(fast_evaluate(f.mul(z[1:], ks), points))
    m = _next_pow2(n)
    # leaf constants y_i / Z'(p_i), padded with 0 (padded points contribute
    # nothing)
    interp = _pad_to(f.mul(values, w), m).reshape(m, 1)
    nodes = _linear_leaves(_pad_to(points, m))
    while nodes.shape[0] > 1:
        zl, zr = nodes[0::2], nodes[1::2]
        interp = f.add(fast_multiply(interp[0::2], zr),
                       fast_multiply(interp[1::2], zl))
        nodes = fast_multiply(zl, zr)
    out = interp[0]
    # the padded roots at 0 scale the interpolant by prod (X - 0) =
    # X^(m-n) through the sibling zerofiers: strip that exact power shift
    if m > n:
        out = out[m - n :]
    return out[:n]


def fast_coset_evaluate(coeffs, offset: int, root: int, length: int,
                        device=None):
    """Evaluate on the coset offset·⟨root⟩ (ref ntt.py:164-168)."""
    coeffs = _tensor(coeffs, device)
    return nt.coset_evaluate(coeffs, offset, root, length)


def fast_coset_divide(a, b, offset: int, root: int, order: int, device=None):
    """Exact quotient a/b via evaluate-divide-interpolate on a coset large
    enough for the quotient degree (ref ntt.py:191-235). b must divide a
    exactly and be nonzero on the coset. `root` is unused, as in the JAX
    package: the coset's root is that of its size, at least `order`."""
    a = _tensor(a, device)
    b = _tensor(b, a.device)
    la, lb = int(a.shape[-1]), int(b.shape[-1])
    assert lb > 0, "division by zero polynomial"
    if la == 0:
        return torch.zeros((0,), dtype=torch.int64, device=a.device)
    m = _next_pow2(max(la, lb))
    while m < order:
        m *= 2
    w = f.primitive_nth_root(m)
    av = fast_coset_evaluate(_pad_to(a, m), offset, w, m)
    bv = fast_coset_evaluate(_pad_to(b, m), offset, w, m)
    q = nt.coset_interpolate(f.mul(av, f.batch_inverse(bv)), offset, w)
    return q[..., : la - lb + 1]
