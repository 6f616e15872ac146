"""Torch port four-step NTT (kernels B2/B3, `ops/kernel_ntt.py`) vs the JAX
package's `ops/pallas_ntt.py`, exact: field arithmetic has no rounding, so
every comparison is equality of the canonical u64 words.

On the CPU the port's wrappers run their plain torch versions; the JAX
side runs its kernel math on numpy (`_subntt_planes`) or its pallas_calls
in interpret mode. Interpret mode is slow, so each JAX result is computed
once per module. The CUDA kernels are held to the plain versions by the
card-only test at the end and by chip_smoke.py."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_brainfuck_tpu.ops import field as jf
from stark_brainfuck_tpu.ops import limb as L
from stark_brainfuck_tpu.ops import pallas_ntt as PN
from stark_brainfuck_tpu_torch.convert import tensor_to_u64 as U
from stark_brainfuck_tpu_torch.convert import u64_to_tensor as T
from stark_brainfuck_tpu_torch.ops import kernel_ntt as K

torch.set_num_threads(1)

P = jf.P
EDGES = [0, 1, P - 1]


def _inputs(rows, n, seed):
    """Canonical random words with 0, 1 and p-1 at the start and p-1 last."""
    v = np.random.default_rng(seed).integers(0, P, size=(rows, n), dtype=np.uint64)
    v.flat[:3] = EDGES
    v.flat[-1] = P - 1
    return v


def _run_sub_np(v, plan):
    """v: (B, m) u64 -> (B, m) u64 through the JAX plane-major sub-NTT
    math (the limb conversion of tests/test_pallas_ntt.py)."""
    B, m = v.shape
    planes = [p.astype(np.int8) for p in L.u64_to_limb_planes(v, np)]
    if plan.levels:
        (lp,) = plan.levels
        r1, r2 = lp.r1, lp.r2
        x = [
            np.ascontiguousarray(np.swapaxes(p.reshape(B, r1, r2), 1, 2))
            for p in planes
        ]
    else:
        x = [p.reshape(B, 1, m) for p in planes]
    out = PN._subntt_planes(x, plan, np)
    out_planes = [o.reshape(B, m).astype(np.int32) for o in out]
    return L.limbs_to_u64(out_planes, np)


@pytest.mark.parametrize("logm", [5, 7, 10, 13])
def test_subntt_plain_matches_jax_subntt_planes(logm):
    m = 1 << logm
    root = jf.primitive_nth_root(m)
    v = _inputs(3, m, logm)
    want = _run_sub_np(v, PN._make_sub_plan(m, root, np))
    plan = K.make_kernel_plan(m, root)
    assert plan.c == 1 and plan.sub_r.m == m
    assert np.array_equal(U(K.subntt_plain(T(v), plan.sub_r)), want)
    assert np.array_equal(U(K.subntt(T(v), plan.sub_r)), want)


# n = 2^16 split as r = 2^8, c = 256: two hi-table rows, the case the full
# prove's 2^21 domain reaches (r = 8192, c = 256)
TW_N, TW_R = 1 << 16, 1 << 8


@lru_cache(maxsize=None)
def _jax_twiddle_outer():
    c = TW_N // TW_R
    root = jf.primitive_nth_root(TW_N)
    plan = PN.PallasNttPlan(
        TW_N, TW_R, c, None, None,
        jnp.asarray(
            np.swapaxes(PN._tw_planes(c // 128, TW_R, root, stride=128), 0, 1)
        ),
        jnp.asarray(PN._tw_planes(128, TW_R, root)),
        None,
    )
    v = _inputs(2 * c, TW_R, 16)
    x = jnp.stack(
        [p.astype(jnp.int8) for p in L.u64_to_limb_planes(jnp.asarray(v), jnp)],
        axis=0,
    )
    out = PN._twiddle_outer_call(x, plan, interpret=True)
    got = L.limbs_to_u64([np.asarray(out[s], dtype=np.int32) for s in range(9)], np)
    return v, np.asarray(got)


def test_twiddle_outer_plain_matches_jax_call_two_hi_rows():
    v, want = _jax_twiddle_outer()
    c = TW_N // TW_R
    tw_hi, tw_lo = K.outer_tables(TW_N, TW_R, jf.primitive_nth_root(TW_N))
    assert tuple(tw_hi.shape) == (2, TW_R) and tuple(tw_lo.shape) == (128, TW_R)
    plan = K.KernelNttPlan(TW_N, TW_R, c, None, None, tw_hi, tw_lo)
    assert np.array_equal(U(K.twiddle_outer_plain(T(v), plan)), want)
    assert np.array_equal(U(K.twiddle_outer(T(v), plan)), want)


@lru_cache(maxsize=None)
def _jax_ntt_pallas(logn, inverse):
    n = 1 << logn
    plan = PN.make_pallas_plan(n, jf.primitive_nth_root(n), inverse, jnp)
    v = _inputs(2, n, 100 + logn + inverse)
    return v, np.asarray(PN.ntt_pallas(jnp.asarray(v), plan, interpret=True))


@pytest.mark.parametrize("logn,inverse", [(10, False), (14, False), (10, True)])
def test_ntt_kernel_matches_ntt_pallas_interpret(logn, inverse):
    v, want = _jax_ntt_pallas(logn, inverse)
    n = 1 << logn
    plan = K.make_kernel_plan(n, jf.primitive_nth_root(n), inverse)
    if logn > 13:
        assert plan.sub_c is not None, "case must cover the composed path"
    assert np.array_equal(U(K.ntt_kernel(T(v), plan)), want)
    # the batch axes ride along: (1, 2, n) gives the same rows
    assert np.array_equal(U(K.ntt_kernel(T(v[None]), plan))[0], want)


@pytest.mark.parametrize("logn", range(5, 27))
def test_plan_geometry_matches_make_pallas_plan(logn):
    n = 1 << logn
    root = jf.primitive_nth_root(n)
    jp = PN.make_pallas_plan(n, root, False, np)
    kp = K.make_kernel_plan(n, root)
    assert K.plan_geometry(n) == (jp.r, jp.c) == (kp.r, kp.c)
    assert (jp.sub_c is None) == (kp.sub_c is None)
    assert kp.sub_r.m == jp.sub_r.m
    if kp.sub_c is not None:
        assert kp.sub_c.m == jp.sub_c.m
        assert tuple(kp.tw_hi.shape) == (jp.tw_hi.shape[0], kp.r)
        assert tuple(kp.tw_lo.shape) == (128, kp.r)


def test_wrappers_reject_other_devices_and_count_no_cpu_launches():
    plan = K.make_kernel_plan(1 << 14, jf.primitive_nth_root(1 << 14))
    meta = torch.empty((256, 128), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        K.subntt(meta, plan.sub_r)
    with pytest.raises(ValueError, match="meta"):
        K.twiddle_outer(meta, plan)
    with pytest.raises(ValueError):
        K.subntt(T(_inputs(2, 64, 0)), plan.sub_r)  # width is not m
    with pytest.raises(ValueError):
        K.twiddle_outer(T(_inputs(3, 128, 0)), plan)  # rows not a multiple of c
    before = (K.LAUNCHES_SUBNTT, K.LAUNCHES_TWIDDLE)
    K.ntt_kernel(T(_inputs(2, 1 << 14, 0)), plan)
    assert (K.LAUNCHES_SUBNTT, K.LAUNCHES_TWIDDLE) == before, (
        "the CPU path must not count kernel launches"
    )


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: kernels B2 and B3 and the composed transform against
    the plain torch versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels B2/B3 have no CPU mode)")
    for logn in (5, 13, 14, 21):
        n = 1 << logn
        plan = K.make_kernel_plan(n, jf.primitive_nth_root(n), False, "cuda")
        v = T(_inputs(3, n, logn), "cuda")
        got = K.ntt_kernel(v, plan)
        if plan.sub_c is None:
            assert torch.equal(got, K.subntt_plain(v, plan.sub_r))
            continue
        y = v.reshape(3 * plan.c, plan.r)
        assert torch.equal(K.subntt(y, plan.sub_r), K.subntt_plain(y, plan.sub_r))
        assert torch.equal(K.twiddle_outer(y, plan), K.twiddle_outer_plain(y, plan))
        inv = K.make_kernel_plan(n, jf.primitive_nth_root(n), True, "cuda")
        assert torch.equal(K.ntt_kernel(got, inv), v)
