"""The port's host Merkle trees, test for test of tests/test_merkle.py (the
reference's negative testing: wrong leaf, wrong index, wrong root,
corrupted path, wrong salt must all fail), each with both ways of building
a tree: the C++ engine and hashlib. Roots equal the JAX package's."""

import numpy as np
import pytest

import stark_brainfuck_tpu.protocol.merkle as JM
import stark_brainfuck_tpu_torch.protocol.merkle as TM
from stark_brainfuck_tpu_torch.protocol.channel import encode_leaf
from stark_brainfuck_tpu_torch.protocol.merkle import Merkle, SaltedMerkle

RNG = np.random.default_rng(11)


@pytest.fixture(params=["cpp", "hashlib"])
def tree_engine(request, monkeypatch):
    """Every tree of the test goes to one engine: the C++ engine from one
    leaf up, or hashlib whatever the leaf count."""
    monkeypatch.setattr(TM, "NATIVE_MIN_LEAVES",
                        1 if request.param == "cpp" else 1 << 62)
    calls = []

    def spy(name):
        real = getattr(TM, name)

        def wrapped(*args):
            calls.append(name)
            return real(*args)

        monkeypatch.setattr(TM, name, wrapped)

    spy("_build_nodes_native")
    spy("_build_nodes_python")
    yield calls
    want = "_build_nodes_native" if request.param == "cpp" else (
        "_build_nodes_python")
    assert calls and set(calls) == {want}, calls


def make_leaves(n=32):
    return [encode_leaf(int(v)) for v in RNG.integers(0, 1 << 60, n)]


def test_merkle_roundtrip_and_negatives(tree_engine):
    leaves = make_leaves()
    tree = Merkle(leaves)
    root = tree.root()
    assert root == JM.Merkle(leaves).root()
    for idx in [0, 1, 17, 31]:
        path = tree.open(idx)
        assert Merkle.verify(root, idx, path, leaves[idx])
        # wrong leaf
        assert not Merkle.verify(root, idx, path, leaves[(idx + 1) % 32])
        # wrong index
        assert not Merkle.verify(root, idx ^ 1, path, leaves[idx])
        # wrong root
        assert not Merkle.verify(b"\x00" * 64, idx, path, leaves[idx])
        # corrupted path element
        bad = list(path)
        bad[0] = bytes(64)
        assert not Merkle.verify(root, idx, bad, leaves[idx])


def test_salted_merkle_roundtrip_and_negatives(tree_engine):
    leaves = make_leaves(16)
    salts = [bytes([i + 1]) * 24 for i in range(16)]
    payloads = [lf + s for lf, s in zip(leaves, salts)]
    tree = SaltedMerkle(payloads, salts)
    root = tree.root()
    assert root == JM.SaltedMerkle(payloads, salts).root()
    for idx in [0, 5, 15]:
        salt, path = tree.open(idx)
        assert salt == salts[idx]
        assert SaltedMerkle.verify(root, idx, path, leaves[idx] + salt)
        # wrong salt
        assert not SaltedMerkle.verify(root, idx, path, leaves[idx] + bytes(24))
        # wrong leaf
        assert not SaltedMerkle.verify(
            root, idx, path, leaves[(idx + 1) % 16] + salt
        )
        # wrong index
        assert not SaltedMerkle.verify(root, idx ^ 1, path, leaves[idx] + salt)


def test_merkle_matches_reference_hashing_shape(tree_engine):
    """Same tree arity/path length as the reference (depth = log2 n)."""
    leaves = make_leaves(64)
    tree = Merkle(leaves)
    assert len(tree.open(0)) == 6
    assert tree.root() == JM.Merkle(leaves).root()
