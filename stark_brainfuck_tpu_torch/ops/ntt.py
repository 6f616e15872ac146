"""NTT / INTT, coset evaluation and the randomized LDE, on the kernel plan.

The API of the JAX package's `ops/ntt.py` (which runs the u64 butterfly
network), on one route: every transform here is `kernel_ntt.ntt_kernel`
with a `kernel_ntt.make_kernel_plan` plan, the four-step transform on
kernels B2/B3 for a CUDA tensor and on their plain versions for a CPU
tensor, bit-identical to the network. A domain above 2^26 points
(`kernel_ntt.KERNEL_NTT_MAX`) has no plan and raises on every device.
Trace interpolation is a subgroup INTT plus the additive randomization
f(x) = trace_poly(x) + (x^H - 1)·r(x).
"""

from __future__ import annotations

import torch

from . import field as f
from . import kernel_ntt as kn


def ntt(values, root: int):
    plan = kn.make_kernel_plan(values.shape[-1], root, False, values.device)
    return kn.ntt_kernel(values, plan)


def intt(values, root: int):
    plan = kn.make_kernel_plan(values.shape[-1], root, True, values.device)
    return kn.ntt_kernel(values, plan)


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


def coset_evaluate_with(coeffs, scale, fwd_plan, length: int):
    """Evaluate polynomials (coefficient rows (..., d)) on the coset of size
    `length` with a precomputed scale table (d,) and forward plan."""
    d = coeffs.shape[-1]
    assert d <= length
    return kn.ntt_kernel(_pad_to(f.mul(coeffs, scale[:d]), length), fwd_plan)


def coset_evaluate(coeffs, offset: int, root: int, length: int):
    """Evaluate polynomials (coefficient rows (..., d)) on the coset
    offset·<root> of size `length`: `FriDomain.evaluate`/`xevaluate`, the
    JAX package's API, which no prover path calls (held to the JAX
    package's by `tests/test_torch_fri.py`)."""
    return coset_evaluate_with(
        coeffs, scale_table(offset, coeffs.shape[-1], coeffs.device),
        kn.make_kernel_plan(length, root, False, coeffs.device), length,
    )


def coset_interpolate(values, offset: int, root: int):
    """Inverse of coset evaluation (host/verifier use)."""
    coeffs = intt(values, root)
    return f.mul(coeffs, scale_table(f.h_inverse(offset), coeffs.shape[-1],
                                     values.device))


# -- randomized LDE ---------------------------------------------------------


def _randomized_coefficients(trace, randomizers, intt_plan):
    """Subgroup INTT of the trace rows plus the (x^H - 1)·r(x) blinding."""
    H = trace.shape[-1]
    coeffs = kn.ntt_kernel(trace, intt_plan)
    if randomizers is not None and randomizers.shape[-1] > 0:
        R = randomizers.shape[-1]
        assert R <= H, "num_randomizers must not exceed the trace height"
        head = f.sub(coeffs[..., :R], randomizers)
        coeffs = torch.cat([head, coeffs[..., R:], randomizers], dim=-1)
    return coeffs


def lde_coefficients_unpadded(trace, randomizers, intt_plan, scale):
    """Coset-scaled coefficient rows of the randomized LDE at their natural
    length H (+R): the persistent per-row state of the streamed prover,
    which evaluates them class by class instead of through one padded
    full-domain NTT."""
    coeffs = _randomized_coefficients(trace, randomizers, intt_plan)
    return f.mul(coeffs, scale[: coeffs.shape[-1]])


def lde_coefficients(trace, randomizers, intt_plan, scale, length: int):
    """Coset-scaled, zero-padded coefficient rows of the randomized LDE,
    ready to batch into one shared forward NTT across tables."""
    return _pad_to(
        lde_coefficients_unpadded(trace, randomizers, intt_plan, scale), length
    )


def lde_columns_with(trace, randomizers, intt_plan, scale, fwd_plan,
                     fri_length: int):
    """Randomized LDE: trace (W, H) over the omicron subgroup ->
    (W, fri_length) codewords of f(x) = trace_poly(x) + (x^H - 1)·r(x).
    `scale`: offset powers table of length >= H + R."""
    coeffs = _randomized_coefficients(trace, randomizers, intt_plan)
    return coset_evaluate_with(coeffs, scale, fwd_plan, fri_length)


def lde_xcolumns_with(trace, randomizers, intt_plan, scale, fwd_plan,
                      fri_length: int):
    """Extension-field variant: trace (W, H, 3) -> (W, fri_length, 3); the
    coefficient axis rides along as a batch dim."""
    t = trace.movedim(-1, 0)  # (3, W, H)
    flat_r = None
    if randomizers is not None:
        r = randomizers.movedim(-1, 0)
        flat_r = r.reshape((-1, r.shape[-1]))
    out = lde_columns_with(
        t.reshape((-1, t.shape[-1])), flat_r, intt_plan, scale, fwd_plan,
        fri_length,
    )
    out = out.reshape((3,) + tuple(trace.shape[:-2]) + (fri_length,))
    return out.movedim(0, -1)
