"""Proof stream, Fiat–Shamir, canonical encodings, and FS-derived sampling.

The proof is an ordered list of plain-python objects (ints, 3-tuples of
ints, bytes, tuples/lists thereof) — the same push/pull discipline as ref
`ip.py:4-30`, with Fiat–Shamir = shake_256 over the serialized prefix. The
native codec pins pickle protocol 4 so transcripts are stable across python
versions.

Also hosts the canonical fixed-width leaf encodings used by the Merkle layer
and the FS-derived samplers (challenge weights, query indices) whose
derivations mirror ref `brainfuck_stark.py:114-126` and `fri.py:62-86`.
"""

from __future__ import annotations

import logging
import pickle
from hashlib import blake2b, shake_256
from typing import List

from ..ops import xfield as xf

PICKLE_PROTOCOL = 4

_log = logging.getLogger("stark_brainfuck_tpu_torch.verify")


class ProofStream:
    def __init__(self):
        self.objects: List = []
        self.read_index = 0

    def push(self, obj):
        self.objects.append(obj)

    def pull(self):
        assert self.read_index < len(self.objects), "proof stream exhausted"
        obj = self.objects[self.read_index]
        self.read_index += 1
        return obj

    def serialize(self) -> bytes:
        return pickle.dumps(self.objects, protocol=PICKLE_PROTOCOL)

    def prover_fiat_shamir(self, num_bytes: int = 32) -> bytes:
        return shake_256(self.serialize()).digest(num_bytes)

# ---------------------------------------------------------------------------
# canonical leaf encodings (fixed-width little-endian u64 words)
# ---------------------------------------------------------------------------


def encode_leaf(element) -> bytes:
    """Encode a leaf object: int (base element), 3-tuple (extension
    element), or a tuple mixing both (a zipped codeword row)."""
    out = bytearray()
    _encode_into(out, element)
    return bytes(out)


def _encode_into(out: bytearray, element):
    if isinstance(element, int):
        out += element.to_bytes(8, "little")
    elif isinstance(element, tuple) and len(element) == 3 and all(
        isinstance(c, int) for c in element
    ):
        for c in element:
            out += c.to_bytes(8, "little")
    elif isinstance(element, (tuple, list)):
        for e in element:
            _encode_into(out, e)
    else:
        raise TypeError(f"cannot encode leaf element of type {type(element)}")


class NativeCodec:
    """Canonical fast transcript format: plain-python objects pickled at a
    pinned protocol, fixed-width little-endian leaf encodings."""

    name = "native"

    def make_stream(self) -> ProofStream:
        return ProofStream()

    def salted_payload(self, obj, salt: bytes) -> bytes:
        return encode_leaf(obj) + salt


def make_codec(name: str):
    if name == "native":
        return NativeCodec()
    raise ValueError(f"unknown codec {name!r}")


# ---------------------------------------------------------------------------
# Fiat-Shamir-derived sampling
# ---------------------------------------------------------------------------


def sample_weights(number: int, randomness: bytes) -> List[tuple]:
    """`number` extension elements from a seed; i-th uses blake2b(seed +
    i zero bytes) — mirrors ref brainfuck_stark.py:114-115 (bytes(i) in
    python is i zero bytes)."""
    return [
        xf.h_sample(blake2b(randomness + bytes(i)).digest()) for i in range(number)
    ]


def sample_indices_stark(number: int, randomness: bytes, bound: int) -> List[int]:
    """Query indices for the combination openings (with repetition),
    ref brainfuck_stark.py:117-126."""
    indices = []
    for i in range(number):
        digest = blake2b(randomness + bytes(i)).digest()
        integer = int.from_bytes(digest, "big")
        indices.append(integer % bound)
    return indices


def sample_index(byte_array: bytes, size: int) -> int:
    acc = 0
    for b in byte_array:
        acc = (acc << 8) ^ b
    return acc % size


def sample_indices_fri(
    seed: bytes, size: int, reduced_size: int, number: int
) -> List[int]:
    """FRI query indices, deduplicated modulo the last codeword size
    (ref fri.py:68-86)."""
    assert number <= reduced_size, "cannot sample more indices than available"
    indices: List[int] = []
    reduced: List[int] = []
    counter = 0
    while len(indices) < number:
        index = sample_index(blake2b(seed + bytes(counter)).digest(), size)
        counter += 1
        r = index % reduced_size
        if r not in reduced:
            indices.append(index)
            reduced.append(r)
    return indices
