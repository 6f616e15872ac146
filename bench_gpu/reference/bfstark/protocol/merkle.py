"""Merkle commitments over canonical leaf byte encodings.

Host trees (a copy of the JAX package's `protocol/merkle.py`). Tree shape
matches ref `merkle.py` / `salted_merkle.py` (BLAKE2b-512, heap-array nodes
in one contiguous buffer, index-bit-walk auth paths, 24-byte salts), every
node hashed with hashlib. The prover uses these trees below
`StarkConfig.device_commit_min` and for the FRI tail; the verifier always.
"""

from __future__ import annotations

from hashlib import blake2b
from typing import List, Sequence

HASH_LEN = 64


def _build_nodes_python(payloads: Sequence[bytes], count: int) -> bytearray:
    nodes = bytearray(2 * count * HASH_LEN)
    for i, p in enumerate(payloads):
        off = (count + i) * HASH_LEN
        nodes[off : off + HASH_LEN] = blake2b(p).digest()
    for k in range(count - 1, 0, -1):
        child = 2 * k * HASH_LEN
        nodes[k * HASH_LEN : (k + 1) * HASH_LEN] = blake2b(
            bytes(nodes[child : child + 2 * HASH_LEN])
        ).digest()
    return nodes


def _build_nodes_buffer(buf: bytes, plen: int, count: int) -> bytearray:
    """Build the whole tree from a contiguous (count · plen) payload
    buffer."""
    payloads = [buf[i * plen : (i + 1) * plen] for i in range(count)]
    return _build_nodes_python(payloads, count)


def _build_nodes(payloads: Sequence[bytes]) -> bytearray:
    count = len(payloads)
    assert count & (count - 1) == 0 and count > 0, (
        "number of leaves must be a power of two"
    )
    return _build_nodes_python(payloads, count)


class SaltBuffer:
    """Salts packed in one buffer; item access returns (and caches) stable
    bytes objects so repeated openings push identical salt objects —
    required by the reference-format pickle memoization."""

    def __init__(self, buf: bytes, salt_len: int = 24):
        self.buf = buf
        self.salt_len = salt_len
        self._cache = {}

    def __len__(self):
        return len(self.buf) // self.salt_len

    def __getitem__(self, i: int) -> bytes:
        if i not in self._cache:
            n = self.salt_len
            self._cache[i] = self.buf[i * n : (i + 1) * n]
        return self._cache[i]


class _TreeBase:
    nodes: bytearray
    num_leafs: int
    depth: int

    def _node(self, k: int) -> bytes:
        """Node digest as a *stable* bytes object: repeated openings that
        share a sibling push the identical object, which pickle serializes
        as a memo reference — smaller proofs, and byte-identical transcripts
        with the device trees (whose node caches share the same way)."""
        cache = getattr(self, "_node_cache", None)
        if cache is None:
            cache = self._node_cache = {}
        if k not in cache:
            cache[k] = bytes(self.nodes[k * HASH_LEN : (k + 1) * HASH_LEN])
        return cache[k]

    def root(self) -> bytes:
        return self._node(1)

    def _path(self, index: int) -> List[bytes]:
        path = []
        index = (1 << self.depth) | index
        while index > 1:
            path.append(self._node(index ^ 1))
            index >>= 1
        return path


class Merkle(_TreeBase):
    """Plain Merkle tree (combination codeword + FRI rounds,
    ref merkle.py:7-63)."""

    def __init__(self, payloads: Sequence[bytes]):
        self.num_leafs = len(payloads)
        self.depth = (self.num_leafs - 1).bit_length() if self.num_leafs > 1 else 0
        self.nodes = _build_nodes(payloads)

    @classmethod
    def from_buffer(cls, buf: bytes, plen: int, count: int) -> "Merkle":
        tree = cls.__new__(cls)
        tree.num_leafs = count
        tree.depth = (count - 1).bit_length() if count > 1 else 0
        tree.nodes = _build_nodes_buffer(buf, plen, count)
        return tree

    def open(self, index: int) -> List[bytes]:
        return self._path(index)

    @staticmethod
    def verify(root: bytes, index: int, path: List[bytes], payload: bytes) -> bool:
        running = blake2b(payload).digest()
        for node in path:
            if index % 2 == 0:
                running = blake2b(running + node).digest()
            else:
                running = blake2b(node + running).digest()
            index >>= 1
        return running == root


class SaltedMerkle(_TreeBase):
    """Merkle tree with a 24-byte salt hashed into every leaf — ZK hiding
    for the base/extension commitments (ref salted_merkle.py:7-68).

    `salted_payloads[i]` is the exact BLAKE2b input for leaf i (the codec
    decides how element+salt combine: raw concatenation for the native
    format)."""

    SALT_LEN = 24

    def __init__(self, salted_payloads: Sequence[bytes], salts):
        assert len(salted_payloads) == len(salts)
        self.num_leafs = len(salted_payloads)
        self.depth = (self.num_leafs - 1).bit_length() if self.num_leafs > 1 else 0
        self.salts = salts
        self.nodes = _build_nodes(salted_payloads)

    @classmethod
    def from_buffer(
        cls, buf: bytes, plen: int, count: int, salts
    ) -> "SaltedMerkle":
        tree = cls.__new__(cls)
        tree.num_leafs = count
        tree.depth = (count - 1).bit_length() if count > 1 else 0
        tree.salts = salts
        tree.nodes = _build_nodes_buffer(buf, plen, count)
        return tree

    def open(self, index: int):
        return self.salts[index], self._path(index)

    @staticmethod
    def verify(
        root: bytes, index: int, path: List[bytes], salted_payload: bytes
    ) -> bool:
        running = blake2b(salted_payload).digest()
        for node in path:
            if index % 2 == 0:
                running = blake2b(running + node).digest()
            else:
                running = blake2b(node + running).digest()
            index >>= 1
        return running == root
