"""The port's streamed (strided-class) commitments against the JAX
package's `protocol/stream.py` (run with xp=np) and against the port's own
resident device trees: folds, class values, roots, openings, rows, salts,
at every group size of classes a dispatch. Inputs come from a numpy seed;
every comparison is exact (integers)."""

import hashlib

import numpy as np
import pytest
import torch

from stark_brainfuck_tpu.ops import field as jf
from stark_brainfuck_tpu.ops import ntt as jnt
from stark_brainfuck_tpu.protocol import device_merkle as jdm
from stark_brainfuck_tpu.protocol import stream as jstream
from stark_brainfuck_tpu_torch.convert import (
    digest_planes_to_words,
    digest_words_to_planes,
    groups_to_tensors,
    tensor_to_u64,
    u64_to_tensor,
)
from stark_brainfuck_tpu_torch.ops import blake2b as B2
from stark_brainfuck_tpu_torch.ops import kernel_ntt as kn
from stark_brainfuck_tpu_torch.ops import ntt as nt
from stark_brainfuck_tpu_torch.protocol import device_merkle
from stark_brainfuck_tpu_torch.protocol import stream as ts
from stark_brainfuck_tpu_torch.protocol.device_merkle import (
    DeviceMerkle,
    DeviceSaltedMerkle,
    salt_key_words,
    salt_words_device,
)
from stark_brainfuck_tpu_torch.utils import metrics as M

torch.set_num_threads(1)

U64 = np.uint64
KEY = b"0123456789abcdef"


def _setup(N=2048, B=8, seed=0):
    """Random offset-prescaled coefficient groups (one longer than S for
    every B here, one ragged, one tiny), the full-domain codeword rows they
    evaluate to, and both packages' stream plans."""
    rng = np.random.default_rng(seed)
    omega = jf.primitive_nth_root(N)
    scale = jnt.scale_table(jf.GENERATOR, N, np)
    groups_np = []
    for d in (N // 4, N // 8 + 1, 3):
        raw = rng.integers(0, jf.P, (2, d), dtype=np.uint64)
        groups_np.append(jf.mul(raw, scale[:d], np))
    pack_N = jnt.make_pack(N, omega, False, np)
    rows_full = []
    for g in groups_np:
        padded = np.concatenate(
            [g, np.zeros((g.shape[0], N - g.shape[1]), dtype=U64)], axis=1
        )
        rows_full.append(jnt.ntt_with(padded, pack_N, np))
    zipped = np.ascontiguousarray(np.concatenate(rows_full, axis=0).T)
    plan_j = jstream.make_stream_plan(N, B, omega, np)
    plan_t = ts.make_stream_plan(N, B, omega, "cpu")
    return tuple(groups_np), groups_to_tensors(groups_np), zipped, plan_j, plan_t


@pytest.mark.parametrize(
    "d,S", [(5, 16), (16, 16), (128, 16), (37, 16), (1, 8)],
    ids=["d<S", "d=S", "d=8S", "ragged", "d=1"],
)
def test_fold_mod_matches_jax(d, S):
    rng = np.random.default_rng(d * 100 + S)
    c = rng.integers(0, jf.P, (3, d), dtype=np.uint64)
    c[0, 0] = jf.P - 1
    want = jstream.fold_mod(c, S, np)
    got = tensor_to_u64(ts.fold_mod(u64_to_tensor(c), S))
    assert got.shape == (3, S)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("N", [2048, 1 << 16], ids=["N2048", "N65536"])
@pytest.mark.parametrize("B", [2, 8])
def test_block_values_match_jax_and_the_codeword(B, N):
    """At N = 2^16 the class transform is the composed plan (B = 2, S =
    2^15) or one sub-transform of SUB_MAX points (B = 8); at N = 2^11 one
    small sub-transform."""
    gj, gt, zipped, plan_j, plan_t = _setup(N=N, B=B)
    S = plan_t["S"]
    assert (plan_t["pack_S"].sub_c is not None) == (S > kn.SUB_MAX)
    scale_len = max(g.shape[1] for g in gj)
    for b in (0, 1, B - 1):
        wb = np.asarray([jf.h_pow(plan_j["omega"], b)], dtype=U64)
        want = jstream.block_values(gj, wb, scale_len, plan_j["pack_S"], S, np)
        got = tensor_to_u64(
            ts.block_values(gt, u64_to_tensor(wb), scale_len,
                            plan_t["pack_S"], S)
        )
        assert np.array_equal(got, want)
        # class b of the full codeword: leaf index b + B·q
        assert np.array_equal(got.T, zipped[b::B])


# N = 2^15 in 2 classes: S = 2^14, the composed plan (c = r = 128)
CASES = [
    pytest.param(2, False, 2048, id="plain-B2"),
    pytest.param(8, False, 2048, id="plain-B8"),
    pytest.param(4, True, 2048, id="salted-B4"),
    pytest.param(2, False, 1 << 15, id="plain-B2-N32768"),
    pytest.param(2, True, 1 << 15, id="salted-B2-N32768"),
]
# the query sets of tests/test_stream.py
PLAIN_IDX = [0, 1, 5, 1023, 2047, 777]
SALTED_IDX = [3, 512, 2046]


def _trees(B, salted, N):
    gj, gt, zipped, plan_j, plan_t = _setup(N=N, B=B)
    key = KEY if salted else None
    jax_tree = jstream.streamed_commit(gj, key, plan_j, np)
    streamed = ts.streamed_commit(gt, key, plan_t)
    return (gj, gt, plan_j, plan_t, jax_tree, streamed,
            _resident(zipped, salted))


def _resident(zipped, salted):
    rows = u64_to_tensor(zipped)
    if salted:
        salts = salt_words_device(salt_key_words(KEY), zipped.shape[0])
        return DeviceSaltedMerkle(rows, salts, cut=2)
    return DeviceMerkle(rows, cut=2)


@pytest.mark.parametrize("B,salted,N", CASES)
def test_streamed_tree_matches_jax_and_resident(B, salted, N):
    gj, gt, plan_j, plan_t, jax_tree, streamed, resident = _trees(
        B, salted, N
    )
    assert streamed.root() == jax_tree.root() == resident.root()
    # the accumulator's top digests, through convert, are JAX's levels[0]
    lo, hi = jax_tree.levels[0]
    assert torch.equal(streamed.levels[0], digest_planes_to_words(lo, hi))
    back = digest_words_to_planes(streamed.levels[0])
    assert np.array_equal(back[0], np.asarray(lo))
    assert np.array_equal(back[1], np.asarray(hi))

    idx = SALTED_IDX if salted else PLAIN_IDX
    streamed.resolve(idx, ts.reopen_rows(gt, plan_t))
    jax_tree.resolve(idx, jstream.reopen_rows(gj, plan_j, np))
    for tree in (streamed, jax_tree, resident):
        tree.prefetch(idx)
    for i in idx:
        assert streamed.open(i) == resident.open(i) == jax_tree.open(i)
        assert np.array_equal(streamed.row_at(i), resident.row_at(i))
        assert np.array_equal(streamed.row_at(i), jax_tree.row_at(i))
        if salted:
            assert streamed.salt_at(i) == resident.salt_at(i)


@pytest.mark.parametrize("salted", [False, True], ids=["plain", "salted"])
def test_open_before_resolve_raises(salted):
    _, gt, _, plan_t, _, streamed, _ = _trees(4, salted, 2048)
    with pytest.raises(RuntimeError, match="resolve"):
        streamed.prefetch([7])
    with pytest.raises(RuntimeError, match="resolve"):
        streamed.row_at(7)
    streamed.resolve([7], ts.reopen_rows(gt, plan_t))
    streamed.open(7)
    # index 7 resolved itself, not the rest of its run of B leaves
    with pytest.raises(RuntimeError, match="resolve"):
        streamed.open(4)
    with pytest.raises(RuntimeError, match="resolve"):
        streamed.prefetch([8])


@pytest.mark.parametrize("salted", [False, True], ids=["plain", "salted"])
def test_32_classes_open_like_the_resident_tree(salted, monkeypatch):
    """B = 32 over 2^14 leaves (512 positions): a few hundred positions
    opened at once, as 160 STARK indices and their neighbours open them.
    Each position's run of 32 leaves is hashed once (`open_runs`), no
    hashlib is called, and the paths, rows and salts equal the resident
    tree's."""
    N, B = 1 << 14, 32
    _, gt, zipped, _, plan_t = _setup(N=N, B=B)
    resident = _resident(zipped, salted)
    streamed = ts.streamed_commit(gt, KEY if salted else None, plan_t)
    assert streamed.root() == resident.root()
    picks = np.random.default_rng(23).integers(0, N, 160)
    idx = sorted({int(i + d) % N for i in picks for d in (0, 1, N // 8)})
    positions = {i // B for i in idx}
    assert len(positions) > 200

    def refuse(*a, **kw):
        raise AssertionError("hashlib called while opening")

    monkeypatch.setattr(device_merkle, "blake2b", refuse)
    monkeypatch.setattr(hashlib, "blake2b", refuse)
    runs = M.COUNTERS.index("open_runs")
    before = M.counters()[runs]
    streamed.resolve(idx, ts.reopen_rows(gt, plan_t))
    assert M.counters()[runs] - before == len(positions)
    assert sorted(streamed._row_cache) == idx
    for tree in (streamed, resident):
        tree.prefetch(idx)
    for i in idx:
        assert streamed.open(i) == resident.open(i)
        assert np.array_equal(streamed.row_at(i), resident.row_at(i))
        assert np.array_equal(streamed.row_at(i), zipped[i])


def test_resolve_asks_only_for_missing_positions():
    _, gt, _, plan_t, _, streamed, _ = _trees(4, False, 2048)
    asked = []
    rows_for = ts.reopen_rows(gt, plan_t)

    def spy(positions):
        asked.append(list(positions))
        return rows_for(positions)

    streamed.resolve([0, 1, 9], spy)
    streamed.resolve([2, 9, 400], spy)
    streamed.resolve([3], spy)
    streamed.resolve([0, 1, 2, 3, 9, 400], spy)
    assert asked == [[0, 2], [0, 100], [0]]


def test_accumulator_takes_reduced_groups_at_their_level():
    """Classes reduced pairwise before they are added (level=1) give the
    digests of adding them one by one."""
    rng = np.random.default_rng(5)
    digs = [
        u64_to_tensor(rng.integers(0, 1 << 63, (32, 8), dtype=np.uint64))
        for _ in range(8)
    ]
    one_by_one = ts.StreamAccumulator()
    for d in digs:
        one_by_one.add(d)
    grouped = ts.StreamAccumulator()
    for k in range(0, 8, 2):
        grouped.add(B2.merkle_parents_pair(digs[k], digs[k + 1]), level=1)
    lvl_a, top_a = one_by_one.finish()
    lvl_b, top_b = grouped.finish()
    assert lvl_a == lvl_b == 3
    assert torch.equal(top_a, top_b)


def test_accumulator_rejects_a_class_count_that_is_no_power_of_two():
    acc = ts.StreamAccumulator()
    for _ in range(3):
        acc.add(torch.zeros((4, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="power of two"):
        acc.finish()
    with pytest.raises(ValueError, match="power of two"):
        ts.StreamedMerkle(48, 6, torch.zeros((8, 8), dtype=torch.int64))


def test_merkle_parents_pair_matches_jax_and_the_heap_form():
    rng = np.random.default_rng(9)
    left = rng.integers(0, 1 << 64, (64, 8), dtype=np.uint64)
    right = rng.integers(0, 1 << 64, (64, 8), dtype=np.uint64)
    got = B2.merkle_parents_pair(u64_to_tensor(left), u64_to_tensor(right))
    l_lo, l_hi = digest_words_to_planes(u64_to_tensor(left))
    r_lo, r_hi = digest_words_to_planes(u64_to_tensor(right))
    from stark_brainfuck_tpu.ops import blake2b as JB

    lo, hi = JB.merkle_parents_pair(l_lo, l_hi, r_lo, r_hi, np)
    assert torch.equal(got, digest_planes_to_words(lo, hi))
    heap = np.stack([left, right], axis=1).reshape(128, 8)
    assert torch.equal(got, B2.merkle_parents(u64_to_tensor(heap)))


@pytest.mark.parametrize("start", [0, (1 << 26) - 40, (1 << 32) - 40],
                         ids=["0", "2^26", "2^32"])
def test_salts_at_explicit_indices_match_jax(start):
    """Strided leaf indices b + B·q up to the largest domain (2^26) and to
    the end of JAX's u32 counter, against the JAX salt PRF and against a
    slice of the port's counter form."""
    idx = start + 5 + 4 * np.arange(8, dtype=np.int64)
    got = salt_words_device(salt_key_words(KEY), 8,
                            indices=torch.from_numpy(idx))
    want = jdm.salt_words(KEY, 8, np, indices=idx.astype(np.uint32))
    lo_hi = np.asarray(want, dtype=np.uint64).reshape(8, 3, 2)
    assert np.array_equal(
        tensor_to_u64(got), lo_hi[:, :, 0] | (lo_hi[:, :, 1] << np.uint64(32))
    )
    if start == 0:
        whole = salt_words_device(salt_key_words(KEY), 40)
        assert torch.equal(got, whole[torch.from_numpy(idx)])


def test_salt_indices_are_checked():
    key = salt_key_words(KEY)
    with pytest.raises(ValueError):
        salt_words_device(key, 4, indices=torch.arange(5))
    with pytest.raises(ValueError):
        salt_words_device(key, 4, indices=torch.arange(4, dtype=torch.int32))


def test_lde_coefficients_unpadded_matches_jax_and_the_padded_form():
    rng = np.random.default_rng(3)
    H, R, N = 64, 2, 512
    omicron = jf.primitive_nth_root(H)
    trace = rng.integers(0, jf.P, (5, H), dtype=np.uint64)
    rand = rng.integers(0, jf.P, (5, R), dtype=np.uint64)
    want = jnt.lde_coefficients_unpadded(
        trace, rand, jnt.make_pack(H, omicron, True, np),
        jnt.scale_table(jf.GENERATOR, H + R, np), np,
    )
    pack = kn.make_kernel_plan(H, omicron, True)
    scale = nt.scale_table(jf.GENERATOR, H + R)
    got = nt.lde_coefficients_unpadded(
        u64_to_tensor(trace), u64_to_tensor(rand), pack, scale
    )
    assert got.shape == (5, H + R)
    assert np.array_equal(tensor_to_u64(got), want)
    padded = nt.lde_coefficients(
        u64_to_tensor(trace), u64_to_tensor(rand), pack, scale, N
    )
    assert torch.equal(padded[:, : H + R], got)
    assert not padded[:, H + R :].any()


def test_stream_plan_root_and_sizes():
    # S = 2^13: one sub-transform of SUB_MAX points; S = 2^14: the composed
    # four-step transform; both against the JAX package's network
    B = 4
    for N in (1 << 15, 1 << 16):
        omega = jf.primitive_nth_root(N)
        plan = ts.make_stream_plan(N, B, omega, "cpu")
        assert (plan["N"], plan["B"], plan["S"]) == (N, B, N // B)
        pack_S = plan["pack_S"]
        assert pack_S.n == N // B
        assert (pack_S.r, pack_S.c) == ((128, 128) if N // B > kn.SUB_MAX
                                        else (N // B, 1))
        x = np.random.default_rng(1).integers(0, jf.P, (2, N // B),
                                              dtype=np.uint64)
        want = jnt.ntt(x, jf.h_pow(omega, B), np)
        got = kn.ntt_kernel(u64_to_tensor(x), pack_S)
        assert np.array_equal(tensor_to_u64(got), want)


# -- classes grouped into one dispatch (`group_size_for`) -------------------

PROVE_SHAPES = [((32, 1 << 17), 8), ((2, 1 << 21), 2), ((32, 1 << 21), 8)]


@pytest.mark.parametrize("env", [None, 0, 1, 2, 3, 4, 8, 16, 64])
def test_group_size_for_matches_jax(env):
    for B in (1, 2, 4, 8, 16, 32, 64, 128):
        for logS in (4, 10, 17, 20, 21, 22, 23, 24):
            want = jstream.group_size_for(B, 1 << logS, env)
            assert ts.group_size_for(B, 1 << logS, env) == want, (B, logS)


def test_group_size_for_at_the_prove_shapes():
    """FRI 2^22 in 32 and in 2 classes, FRI 2^26 in 32: the check comes
    before the doubling, so a group of 8 classes of 2^21 positions."""
    for (B, S), G in PROVE_SHAPES:
        assert ts.group_size_for(B, S) == jstream.group_size_for(B, S) == G


# each class group on both sides of SUB_MAX: S = 2^8 and 2^14 (B = 8), or
# S = 2^14 and 2^13 (B = 4); from 2^14 up the class transform is the
# composed four-step plan, below it one sub-transform
@pytest.mark.parametrize("N,B,b0,G", [
    (2048, 8, 0, 8), (2048, 8, 2, 2), (2048, 8, 4, 4), (2048, 8, 5, 3),
    (1 << 16, 4, 0, 4),
    (1 << 17, 8, 0, 8), (1 << 17, 8, 2, 2), (1 << 17, 8, 4, 4),
    (1 << 17, 8, 5, 3), (1 << 15, 4, 0, 4),
])
def test_group_values_stack_the_class_values(N, B, b0, G):
    """G classes in one evaluation equal G evaluations of one class and
    the classes of the full codeword."""
    _, gt, zipped, _, plan_t = _setup(N=N, B=B)
    S = plan_t["S"]
    scale_len = max(int(g.shape[1]) for g in gt)
    wbs = ts._class_roots(plan_t, "cpu")
    got = ts.group_values(gt, wbs[b0 : b0 + G], scale_len, plan_t["pack_S"],
                          S)
    assert tuple(got.shape) == (G, zipped.shape[1], S)
    for j in range(G):
        one = ts.block_values(gt, wbs[b0 + j : b0 + j + 1], scale_len,
                              plan_t["pack_S"], S)
        assert torch.equal(got[j], one)
        assert np.array_equal(tensor_to_u64(got[j]).T, zipped[b0 + j :: B])


# B = 8 and B = 16 classes: at 16 even G = 8 leaves two groups a pass, so
# the accumulator combines groups at level log2(G)
GROUP_CASES = [
    pytest.param(G, salted, B,
                 id=f"G{G}-{'salted' if salted else 'plain'}-B{B}")
    for G in (1, 2, 4, 8) for salted in (False, True) for B in (8, 16)
]


@pytest.mark.parametrize("G,salted,B", GROUP_CASES)
def test_grouped_tree_matches_jax_ungrouped_and_resident(G, salted, B):
    """plan["group"] = G in both packages: roots, the level-log2(B)
    digests, opened rows, salts and paths equal the JAX package's, the
    port's one class a dispatch and the resident tree's."""
    gj, gt, zipped, plan_j, plan_t = _setup(B=B)
    resident = _resident(zipped, salted)
    key = KEY if salted else None
    plan_j["group"] = plan_t["group"] = G
    jax_tree = jstream.streamed_commit(gj, key, plan_j, np)
    grouped = ts.streamed_commit(gt, key, plan_t)
    single = ts.streamed_commit(gt, key, {**plan_t, "group": 1})
    assert grouped.root() == jax_tree.root() == single.root() == resident.root()
    lo, hi = jax_tree.levels[0]
    assert torch.equal(grouped.levels[0], digest_planes_to_words(lo, hi))
    assert torch.equal(grouped.levels[0], single.levels[0])

    idx = SALTED_IDX if salted else PLAIN_IDX
    grouped.resolve(idx, ts.reopen_rows(gt, plan_t))
    single.resolve(idx, ts.reopen_rows(gt, {**plan_t, "group": 1}))
    jax_tree.resolve(idx, jstream.reopen_rows(gj, plan_j, np))
    for tree in (grouped, single, jax_tree, resident):
        tree.prefetch(idx)
    for i in idx:
        assert grouped.open(i) == jax_tree.open(i) == single.open(i)
        assert grouped.open(i) == resident.open(i)
        assert np.array_equal(grouped.row_at(i), jax_tree.row_at(i))
        assert np.array_equal(grouped.row_at(i), resident.row_at(i))
        if salted:
            assert grouped.salt_at(i) == jax_tree.salt_at(i)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_reopen_rows_match_jax_at_every_group(G):
    """The (Q, B, k) rows of the second pass, position for position."""
    gj, gt, zipped, plan_j, plan_t = _setup(B=8)
    plan_j["group"] = plan_t["group"] = G
    positions = [0, 3, 17, 255]
    got = tensor_to_u64(ts.reopen_rows(gt, plan_t)(positions))
    want = jstream.reopen_rows(gj, plan_j, np)(positions)
    assert got.shape == (4, 8, zipped.shape[1])
    assert np.array_equal(got, want)
    for j, q in enumerate(positions):
        assert np.array_equal(got[j], zipped[q * 8 : (q + 1) * 8])


@pytest.mark.parametrize("salted", [False, True], ids=["plain", "salted"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_dispatches_per_group(G, salted, monkeypatch):
    """B/G class transforms a pass; a group hashes its leaves once, its
    salts once (salted) and each of its log2(G) pair levels once; then
    B/G - 1 accumulator combines and the ladder."""
    B = 8
    _, gt, _, _, plan_t = _setup(B=B)
    plan_t["group"] = G
    calls = {"ntt": 0, "hash": 0}
    ntt, hash_words = kn.ntt_kernel, B2.blake2b_words

    def count_ntt(*a, **kw):
        calls["ntt"] += 1
        return ntt(*a, **kw)

    def count_hash(*a, **kw):
        calls["hash"] += 1
        return hash_words(*a, **kw)

    monkeypatch.setattr(kn, "ntt_kernel", count_ntt)
    monkeypatch.setattr(B2, "blake2b_words", count_hash)
    tree = ts.streamed_commit(gt, KEY if salted else None, plan_t)
    log_g = G.bit_length() - 1
    per_group = (2 if salted else 1) + log_g
    ladder = len(tree.levels) - 1
    assert calls == {"ntt": B // G,
                     "hash": B // G * per_group + (B // G - 1) + ladder}
    calls.update(ntt=0, hash=0)
    ts.reopen_rows(gt, plan_t)([1, 2])
    assert calls == {"ntt": B // G, "hash": 0}
