"""Openings of the port's device Merkle trees against its host trees: the
pruned bottom levels of every opened path are hashed again on the device
(the plain torch BLAKE2b here, kernel B1 on the card) in the gather that
fetches the openings. Paths, salts and rows equal the host
`Merkle` / `SaltedMerkle` ones at every cut, alone, in mixed batches and
opened lazily; trees of one leaf shape share one set of hash launches; the
`open_runs` counter counts the runs hashed; nothing calls hashlib while a
device tree opens. The streamed trees' openings are held to the resident
tree in tests/test_torch_stream.py."""

import hashlib

import numpy as np
import pytest
import torch

from stark_brainfuck_tpu_torch.convert import u64_to_tensor as T
from stark_brainfuck_tpu_torch.ops import blake2b as B
from stark_brainfuck_tpu_torch.protocol import device_merkle as dm
from stark_brainfuck_tpu_torch.protocol.merkle import Merkle, SaltBuffer, SaltedMerkle
from stark_brainfuck_tpu_torch.protocol.stark import _salted_payload_buffer
from stark_brainfuck_tpu_torch.utils import metrics as M

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001
KEY = bytes(range(16))
OPEN_RUNS = M.COUNTERS.index("open_runs")


def _pair(n, k, salted, cut=None, seed=0):
    """A device tree over random (n, k) field rows (salted: with the salt
    PRF's salts) and the host tree over the same leaves."""
    rows = np.random.default_rng(seed + n + k).integers(
        0, P, size=(n, k), dtype=np.uint64)
    if salted:
        salts = dm.salt_words_device(dm.salt_key_words(KEY), n)
        tree = dm.DeviceSaltedMerkle(T(rows), salts, cut=cut)
        salt_buf = SaltBuffer(dm.salt_words_to_buffer(salts))
        buf, plen = _salted_payload_buffer(rows, salt_buf.buf)
        host = SaltedMerkle.from_buffer(buf, plen, n, salt_buf)
    else:
        tree = dm.DeviceMerkle(T(rows), cut=cut)
        host = Merkle.from_buffer(rows.astype("<u8").tobytes(), 8 * k, n)
    assert tree.root() == host.root()
    return tree, host, rows


def _picks(n, cut):
    """Both ends of a run, two leaves of one run, a duplicate, the last
    leaf and one in the middle."""
    run = 1 << cut
    picks = [0, run - 1, run, 2 * run - 1, 5 * run + run // 2,
             5 * run + run // 2 + (1 if run > 1 else 0), n // 2, n - 1, n - 1]
    return picks


def _open_runs():
    return M.counters()[OPEN_RUNS]


def _check(tree, host, rows, picks):
    for i in picks:
        assert tree.open(i) == host.open(i), i
        assert np.array_equal(tree.row_at(i), rows[i])


# a tree keeps its levels from `cut` up to the host cut's 512 nodes, so
# 2^10 leaves take a cut of at most 1 (its default)
SIZES_AND_CUTS = [(1 << 10, 0), (1 << 10, "default")] + [
    (n, cut) for n in (1 << 14, 1 << 15) for cut in (0, 3, "default")]


@pytest.mark.parametrize("salted", [False, True], ids=["plain", "salted"])
@pytest.mark.parametrize("n,cut", SIZES_AND_CUTS)
def test_device_tree_opens_like_the_host_tree(n, cut, salted):
    cut = dm.default_cut(n) if cut == "default" else cut
    tree, host, rows = _pair(n, 3 if not salted else 5, salted, cut)
    assert tree.cut == cut
    picks = _picks(n, cut)
    before = _open_runs()
    tree.prefetch(picks)
    runs = len({i >> cut for i in picks}) if cut else 0
    assert _open_runs() - before == runs
    # the rows held are the opened ones, not whole runs
    assert sorted(tree._row_cache) == sorted(set(picks))
    _check(tree, host, rows, picks)
    # everything was fetched: opening again hashes nothing more
    assert _open_runs() - before == runs


def test_trees_of_one_leaf_shape_share_the_hash_launches(monkeypatch):
    """One batch over five trees of mixed widths, salting and cuts: one
    set of launches (leaves, then cut - 1 parent levels) a leaf shape, and
    every opening equal to its host tree's."""
    specs = [(1 << 12, 3, False, 3), (1 << 13, 3, False, 3),
             (1 << 14, 3, False, 3), (1 << 12, 5, True, 3),
             (1 << 13, 5, True, 4)]
    pairs = [_pair(n, k, salted, cut, seed=j)
             for j, (n, k, salted, cut) in enumerate(specs)]
    picks = [[7, 8, 9, 100, (n >> 1) + 3, n - 1] for n, *_ in specs]
    calls = []
    inner = B.blake2b_words

    def counting(words, msg_len):
        calls.append(int(words.shape[0]))
        return inner(words, msg_len)

    monkeypatch.setattr(B, "blake2b_words", counting)
    before = _open_runs()
    dm.prefetch_trees([(tree, p) for (tree, _, _), p in zip(pairs, picks)])
    runs = [len({i >> cut for i in p}) for (*_, cut), p in zip(specs, picks)]
    assert _open_runs() - before == sum(runs)
    # (3, plain, cut 3) for three trees, (5, salted, 3), (5, salted, 4)
    assert len(calls) == 3 + 3 + 4
    assert calls[0] == 8 * sum(runs[:3])
    monkeypatch.undo()
    for (tree, host, rows), p in zip(pairs, picks):
        _check(tree, host, rows, p)


@pytest.mark.parametrize("salted", [False, True], ids=["plain", "salted"])
def test_an_index_not_prefetched_opens_lazily(salted):
    """open, row_at and salt_at of leaves no prefetch asked for: one in a
    run hashed before (its siblings below the cut not yet held), one in a
    run never touched, one in a run of a leaf opened lazily before."""
    n = 1 << 13
    tree, host, rows = _pair(n, 5, salted, cut=4)
    tree.prefetch([40])
    before = _open_runs()
    assert tree.open(41) == host.open(41)
    assert tree.open(1000) == host.open(1000)
    assert np.array_equal(tree.row_at(1000), rows[1000])
    assert np.array_equal(tree.row_at(1001), rows[1001])
    if salted:
        assert tree.salt_at(2048) == host.open(2048)[0]
    assert tree.open(2048) == host.open(2048)
    assert tree.open(1001) == host.open(1001)
    # the run of 41 again (for its level-0 sibling 40), of 1000, of 1001
    # again (for 1000), and of 2048
    assert _open_runs() - before == 4


def test_opening_calls_no_hashlib(monkeypatch):
    """Once built (the host top of a tree is hashlib's), device trees open
    without a host hash."""
    trees = [_pair(1 << 12, 3, False)[:2], _pair(1 << 12, 5, True)[:2]]

    def refuse(*a, **kw):
        raise AssertionError("hashlib called while opening")

    monkeypatch.setattr(dm, "blake2b", refuse)
    monkeypatch.setattr(hashlib, "blake2b", refuse)
    for tree, host in trees:
        tree.prefetch([3, 64, 65, 4000])
        for i in (3, 64, 65, 4000, 17):
            assert tree.open(i) == host.open(i)
