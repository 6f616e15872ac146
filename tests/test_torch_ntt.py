"""Torch port NTT, LDE and scans vs the JAX package's numpy path, exact."""

import numpy as np
import pytest
import torch

from stark_brainfuck_tpu.ops import field as jf
from stark_brainfuck_tpu.ops import ntt as jn
from stark_brainfuck_tpu.ops import scan as js
from stark_brainfuck_tpu_torch.convert import tensor_to_u64 as U
from stark_brainfuck_tpu_torch.convert import u64_to_tensor as T
from stark_brainfuck_tpu_torch.ops import kernel_ntt as kn
from stark_brainfuck_tpu_torch.ops import ntt as tn
from stark_brainfuck_tpu_torch.ops import scan as ts

torch.set_num_threads(1)

P = jf.P


@pytest.mark.parametrize("n", [1, 2, 16, 1024, 1 << 14, 1 << 15])
def test_ntt_and_intt_match(n):
    """The kernel plan (one sub-transform up to SUB_MAX, composed from it
    up; a one-point plan is the identity) against the JAX package's
    network."""
    rng = np.random.default_rng(n)
    v = rng.integers(0, P, size=(3, n), dtype=np.uint64)
    root = jf.primitive_nth_root(n)
    fwd = kn.make_kernel_plan(n, root, False)
    assert (fwd.sub_c is not None) == (n > kn.SUB_MAX)
    want = jn.ntt_with(v, jn.make_pack(n, root, False, np), np)
    assert np.array_equal(want, U(kn.ntt_kernel(T(v), fwd)))
    assert np.array_equal(want, U(tn.ntt(T(v), root)))
    assert np.array_equal(jn.intt(v, root, np), U(tn.intt(T(v), root)))
    assert np.array_equal(U(tn.intt(tn.ntt(T(v), root), root)), v)


@pytest.mark.parametrize("H,R", [(8, 1), (64, 2), (256, 0)])
def test_lde_coefficients_and_columns_match(H, R):
    rng = np.random.default_rng(H + R)
    N = 64 * H
    om = jf.primitive_nth_root(H)
    w = jf.primitive_nth_root(N)
    tr = rng.integers(0, P, size=(4, H), dtype=np.uint64)
    r = rng.integers(0, P, size=(4, R), dtype=np.uint64) if R else None
    ipk_j = jn.make_pack(H, om, True, np)
    ipk_t = kn.make_kernel_plan(H, om, True)
    want = jn.lde_coefficients(tr, r, ipk_j, jn.scale_table(7, H + R, np), N, np)
    got = tn.lde_coefficients(
        T(tr), None if r is None else T(r), ipk_t, tn.scale_table(7, H + R), N
    )
    assert np.array_equal(want, U(got))
    xt = rng.integers(0, P, size=(2, H, 3), dtype=np.uint64)
    xr = rng.integers(0, P, size=(2, R, 3), dtype=np.uint64) if R else None
    want = jn.lde_xcolumns(xt, xr, om, 7, w, N, np)
    got = tn.lde_xcolumns_with(
        T(xt), None if xr is None else T(xr), ipk_t, tn.scale_table(7, H + R),
        kn.make_kernel_plan(N, w), N,
    )
    assert np.array_equal(want, U(got))


def test_coset_interpolate_inverts_evaluation():
    rng = np.random.default_rng(9)
    n = 64
    coeffs = rng.integers(0, P, size=(3, n), dtype=np.uint64)
    w = jf.primitive_nth_root(n)
    vals = jn.coset_evaluate(coeffs, 7, w, n, np)
    assert np.array_equal(jn.coset_interpolate(vals, 7, w, np), coeffs)
    assert np.array_equal(U(tn.coset_interpolate(T(vals), 7, w)), coeffs)


def test_batched_affine_scan_matches():
    rng = np.random.default_rng(3)
    lanes = [
        (rng.integers(0, P, size=(h, 3), dtype=np.uint64),
         rng.integers(0, P, size=(h, 3), dtype=np.uint64))
        for h in (1, 5, 16, 33)
    ]
    want = js.batched_affine_scan(lanes, np)
    got = ts.batched_affine_scan([(T(m), T(b)) for m, b in lanes])
    for w_, g in zip(want, got):
        assert np.array_equal(w_, U(g))
    f = lanes[2][0]
    inc = js.inclusive_prefix_mul(f, np)
    init = np.asarray([5, 6, 7], dtype=np.uint64)
    want = js.exclusive_from_inclusive(inc, init, np)
    assert np.array_equal(want, U(ts.exclusive_from_inclusive(T(inc), T(init))))
    m, b = ts.prefix_mul_as_affine(T(f))
    assert np.array_equal(U(ts.batched_affine_scan([(m, b)])[0]), inc)
