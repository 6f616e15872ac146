"""Torch port four-step NTT (kernels B2/B3, `ops/kernel_ntt.py`) vs the JAX
package's `ops/pallas_ntt.py`, exact: field arithmetic has no rounding, so
every comparison is equality of the canonical u64 words.

On the CPU the port's wrappers run their plain torch versions; the JAX
side runs its kernel math on numpy (`_subntt_planes`) or its pallas_calls
in interpret mode. Interpret mode is slow, so each JAX result is computed
once per module. Kernel B2 cannot run here, so its schedule is emulated in
torch (same tile shape, step indices, shared-memory addresses, twiddle
table and strides as csrc/ntt.cu) and its PTX field operations in Python
integers, both held to the plain versions. The CUDA kernels themselves are
held to the plain versions by the card-only test at the end and by
chip_smoke.py."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_brainfuck_tpu.ops import field as jf
from stark_brainfuck_tpu.ops import limb as L
from stark_brainfuck_tpu.ops import ntt as jnt
from stark_brainfuck_tpu.ops import pallas_ntt as PN
from stark_brainfuck_tpu_torch.convert import tensor_to_u64 as U
from stark_brainfuck_tpu_torch.convert import u64_to_tensor as T
from stark_brainfuck_tpu_torch.ops import field as tf
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


@pytest.mark.parametrize("logn", [0, 1, *range(5, 27)])
def test_plan_geometry_invariants_and_exactness(logn):
    """The port's own four-step split: r·c = n, both within a block's
    reach, c >= 128 for B3's factored table, c <= r so the strided pass is
    the shorter one (n = 1, a table of height 1, is one sub-transform, the
    identity); and the transform equals the JAX package's u64 network on a
    table's batch of rows (n <= 2^16, forward and inverse: the tables'
    INTTs), and the inverse undoes the forward transform."""
    n = 1 << logn
    root = jf.primitive_nth_root(n)
    r, c = K.plan_geometry(n)
    assert r * c == n and r <= K.SUB_MAX and c <= K.SUB_MAX
    if n <= K.SUB_MAX:
        assert (r, c) == (n, 1)
    else:
        assert 128 <= c <= r <= 2 * c or c == 128
    kp = K.make_kernel_plan(n, root)
    assert (kp.r, kp.c, kp.sub_r.m) == (r, c, r)
    assert (kp.sub_c is None) == (c == 1)
    for sub in (kp.sub_r, kp.sub_c):
        if sub is not None:
            radices = K.step_radices(sub.m)
            assert int(np.prod(radices)) == sub.m and set(radices[1:]) <= {8}
            assert sub.table.numel() == max(1, sum(
                (R - 1) * (sub.m // int(np.prod(radices[:i + 1])))
                for i, R in enumerate(radices[:-1])))
            assert sub.kappa in (1, 3, 5, 7)
    if c > 1:
        assert kp.sub_c.m == c and kp.sub_c.scale == 1
        assert tuple(kp.tw_hi.shape) == (c // 128, r)
        assert tuple(kp.tw_lo.shape) == (128, r)
    if logn <= 16:
        v = _inputs(9, n, logn)
        got = {}
        for inverse in (False, True):
            plan = K.make_kernel_plan(n, root, inverse)
            want = jnt.ntt_with(v, jnt.make_pack(n, root, inverse, np), np)
            got[inverse] = K.ntt_kernel(T(v), plan)
            assert np.array_equal(U(got[inverse]), want)
        assert np.array_equal(U(K.ntt_kernel(got[True], kp)), v)


# ---------------------------------------------------------------------------
# kernel B2's schedule, emulated in torch: the same tile shape, Stockham
# steps, shared-memory addresses (padding included), shift-only in-register
# DFTs, output permutation by kappa, between-step table and global strides
# as csrc/ntt.cu, for every block at once
# ---------------------------------------------------------------------------


def _mul_pow2(x, k):
    return tf.mul(x, tf.const(1 << k, x) if k < 63 else tf.const(pow(2, k, P), x))


def _dft_pow2(a):
    """csrc/ntt.cu `dft_pow2<R>`: the DFT with the fixed root 2^(192/R) of
    the R tensors in `a`, natural order."""
    R = len(a)
    if R == 2:
        return [tf.add(a[0], a[1]), tf.sub(a[0], a[1])]
    if R == 4:
        e0, e1 = tf.add(a[0], a[2]), tf.add(a[1], a[3])
        f0, f1 = tf.sub(a[0], a[2]), _mul_pow2(tf.sub(a[1], a[3]), 48)
        return [tf.add(e0, e1), tf.add(f0, f1), tf.sub(e0, e1), tf.sub(f0, f1)]
    u = _dft_pow2([tf.add(a[k], a[k + 4]) for k in range(4)])
    v = _dft_pow2([_mul_pow2(tf.sub(a[k], a[k + 4]), 24 * k) for k in range(4)])
    return [w for pair in zip(u, v) for w in pair]


def _emulate_subntt(x, sub, batches, nvec, src, dst):
    m = sub.m
    log_m = m.bit_length() - 1
    log_ti, log_vo = K.tile_shape(m, src.elem != 1 or dst.elem != 1)
    log_M = log_m + log_ti
    E = 1 << (log_M + log_vo)
    assert 64 <= E <= 8192  # 8 words a thread, at most 1,024 threads
    kinv = pow(sub.kappa, -1, 8)
    per_tile = 1 << (log_ti + log_vo)
    tiles = -(-nvec // per_tile)
    block = torch.arange(batches * tiles)[:, None]
    batch, vec0 = block // tiles, (block % tiles) * per_tile
    flat = x.reshape(-1)
    out = torch.full_like(flat, -1)
    pad = lambda a: a + (a >> 4)
    sm = torch.zeros((batches * tiles, pad(E) + 1), dtype=torch.int64)
    rows = torch.arange(batches * tiles)[:, None]
    log_n, log_s, tab_off = log_m, log_ti, 0
    radices = K.step_radices(m)
    for step, R in enumerate(radices):
        first, last = step == 0, step == len(radices) - 1
        LR = R.bit_length() - 1
        log_bf = log_M - LR
        u = torch.arange(E // R)[None, :]
        vo, i = u >> log_bf, u & ((1 << log_bf) - 1)
        a = []
        for k in range(R):
            e = i + (k << log_bf)
            if first:
                vec = vec0 + (vo << log_ti) + (e & ((1 << log_ti) - 1))
                addr = batch * src.batch + vec * src.vec + (e >> log_ti) * src.elem
                ok = vec < nvec
                a.append(torch.where(ok, flat[torch.where(ok, addr, 0)], 0))
            else:
                a.append(sm[rows, pad((vo << log_M) + e)])
        b = _dft_pow2(a)
        q, p = i & ((1 << log_s) - 1), i >> log_s
        for jr in range(R):
            j = (kinv * jr) & (R - 1)
            w = b[jr]
            if not last and jr:
                tw = sub.table[tab_off + ((jr - 1) << (log_n - LR)) + p]
                w = tf.mul(w, tw.expand_as(w))
            d = q + ((p * R + j) << log_s)
            if last:
                assert int(p.max()) == 0
                vec = vec0 + (vo << log_ti) + (d & ((1 << log_ti) - 1))
                addr = batch * dst.batch + vec * dst.vec + (d >> log_ti) * dst.elem
                if sub.scale != 1:
                    w = tf.mul(w, tf.const(sub.scale, w))
                ok = vec < nvec
                out[addr[ok]] = w[ok]
            else:
                sm[rows, pad((vo << log_M) + d)] = w
        tab_off += (R - 1) << (log_n - LR)
        log_n -= LR
        log_s += LR
    return out.reshape(x.shape)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("logm", [5, 7, 8, 10, 13])
def test_b2_schedule_emulation_matches_subntt_plain(logm, inverse):
    """Contiguous rows (ragged: 3 rows in tiles of more), the four-step's
    column pass (strided in and out) and its row pass (rows in, transposed
    out), with a sub-root of every kappa."""
    m = 1 << logm
    B, nvec = 2, 12
    n = m * nvec
    for kappa_pick, power in enumerate((1, 3, 5, 7)):
        root = jf.primitive_nth_root(m)
        root = tf.h_pow(tf.h_inverse(root) if inverse else root, power)
        scale = tf.h_inverse(m) if inverse else 1
        sub = K._sub_plan(m, root, scale, None)
        rows3 = T(_inputs(3, m, logm + power))
        contiguous = K.Strides(0, m, 1)
        want = K.subntt_plain(rows3, sub)
        assert torch.equal(
            _emulate_subntt(rows3, sub, 1, 3, contiguous, contiguous), want)
        assert torch.equal(
            K.subntt_tiled(rows3, sub, 1, 3, contiguous, contiguous), want)
        if power > 3 and logm > 8:
            continue  # the strided forms at every kappa only where cheap
        x = T(_inputs(B, n, 50 + logm + power))
        for src, dst in (
            (K.Strides(n, 1, nvec), K.Strides(n, 1, nvec)),
            (K.Strides(n, m, 1), K.Strides(n, 1, nvec)),
        ):
            want = K.subntt_tiled_plain(x, sub, B, nvec, src, dst)
            got = _emulate_subntt(x, sub, B, nvec, src, dst)
            assert torch.equal(got, want), (src, dst)
    kappas = {K.root_kappa(8, tf.h_pow(jf.primitive_nth_root(8), e))
              for e in (1, 3, 5, 7)}
    assert kappas == {1, 3, 5, 7}


M64, M32 = (1 << 64) - 1, (1 << 32) - 1


def _c_sub(a, b):
    """csrc/goldilocks.cuh `gl_sub` on Python ints with u64 wrap-around."""
    d = (a - b) & M64
    return (d - M32) & M64 if a < b else d


def _c_reduce128(lo, hi):
    """csrc/goldilocks.cuh `reduce128`."""
    t0 = _c_sub(lo, hi >> 32)
    hl = hi & M32
    t1 = ((hl << 32) - hl) & M64
    return _c_sub(t0, P - t1)


def _c_mul_pow2(x, K):
    """csrc/ntt.cu `gl_mul_pow2<K>`."""
    if K <= 32:
        hl = x >> (64 - K)
        return _c_sub((x << K) & M64, P - ((hl << 32) - hl))
    if K < 64:
        return _c_reduce128((x << K) & M64, x >> (64 - K))
    xl8 = (x & 0xFFFFFF) << 8
    return _c_sub(((xl8 << 32) - xl8) & M64, x >> 24)


def test_b2_field_ops_are_canonical():
    """`gl_add`, `gl_sub` and `gl_mul` as the kernels compute them, on edge
    values and random pairs."""
    rng = np.random.default_rng(1)
    xs = EDGES + [P - 2, 2, M32, M32 + 1, 1 << 63, P >> 1]
    xs += [int(v) for v in rng.integers(0, P, size=300, dtype=np.uint64)]
    for a in xs:
        for b in xs[:40]:
            assert _c_sub(a, b) == (a - b) % P
            assert _c_sub(a, P - b) == (a + b) % P
            prod = a * b
            assert _c_reduce128(prod & M64, prod >> 64) == prod % P
    for lo, hi in ((M64, M64), (0, M64), (M64, 0), (P, P), (P - 1, M32)):
        assert _c_reduce128(lo, hi) == (lo + (hi << 64)) % P


@pytest.mark.parametrize("K_shift", [24, 48, 72])
def test_b2_shift_multiplies_are_canonical_products(K_shift):
    rng = np.random.default_rng(K_shift)
    xs = EDGES + [P - 2, 1 << 24, (1 << 24) - 1, (1 << 40) - 1, 1 << 63,
                  0xFFFFFFFF, 0xFFFFFFFF00000000]
    xs += [int(v) for v in rng.integers(0, P, size=2000, dtype=np.uint64)]
    for x in xs:
        assert _c_mul_pow2(x, K_shift) == x * (1 << K_shift) % P, hex(x)


def test_subntt_tiled_rejects_bad_layouts():
    sub = K.make_kernel_plan(32, jf.primitive_nth_root(32)).sub_r
    x = T(_inputs(4, 32, 0))
    rows = K.Strides(0, 32, 1)
    with pytest.raises(ValueError, match="vectors"):
        K.subntt_tiled(x, sub, 1, 3, rows, rows)
    with pytest.raises(ValueError, match="leaves"):
        K.subntt_tiled(x, sub, 1, 4, K.Strides(0, 64, 1), rows)
    with pytest.raises(ValueError, match="contiguous"):
        K.subntt_tiled(x.t(), sub, 1, 4, rows, rows)
    with pytest.raises(ValueError):
        K.plan_geometry(48)


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
        r, c = plan.r, plan.c
        y = v.reshape(3 * c, r)
        assert torch.equal(K.subntt(y, plan.sub_r), K.subntt_plain(y, plan.sub_r))
        assert torch.equal(K.twiddle_outer(y, plan), K.twiddle_outer_plain(y, plan))
        for sub, nvec, src, dst in (
            (plan.sub_c, r, K.Strides(n, 1, r), K.Strides(n, 1, r)),
            (plan.sub_r, c, K.Strides(n, r, 1), K.Strides(n, 1, c)),
        ):
            assert torch.equal(
                K.subntt_tiled(v, sub, 3, nvec, src, dst),
                K.subntt_tiled_plain(v, sub, 3, nvec, src, dst))
        inv = K.make_kernel_plan(n, jf.primitive_nth_root(n), True, "cuda")
        assert torch.equal(K.ntt_kernel(got, inv), v)
