"""Reference-transcript codec: byte-compatible Fiat-Shamir and proof format.

The reference's proof is pickle.dumps of the pushed-object list, its
Fiat-Shamir is shake_256 over the pickle of the prefix (ref ip.py:21-25),
and its Merkle leaf hashing is blake2b over pickled leaf objects
(ref merkle.py:30, salted_merkle.py:32-35). This codec reproduces all
three so that:

  - proofs produced by this framework verify under the reference's
    `BrainfuckStark.verify`, and
  - proofs produced by the reference verify under this framework.

Why this works without replicating the reference prover's exact object
aliasing: the reference *verifier* recomputes Fiat-Shamir from
`pickle.dumps(pickle.loads(proof)[:k])` — i.e. over the object graph as
deserialized from the proof bytes. The prover therefore only needs its OWN
dumps to be self-consistent (stable under a loads/dumps round trip), which
holds as long as repeated pushes of the same logical object push the same
python object (pickle memo refs) — the identity discipline enforced here
and in the prover's leaf caches.

A copy of the JAX package's `interop/refcodec.py`. The port's prover
shares plain objects exactly where the JAX package's prover does (the
leaf caches, FRI round 0's reuse of the combination leaves, fresh tuples in
later rounds), so a seeded ref-codec proof is byte-identical to it, memo
back-references included.
"""

from __future__ import annotations

import pickle
from hashlib import shake_256
from typing import List

from ..ops.field import P
from .ref_shims import ensure_ref_modules


class RefCodec:
    name = "ref"

    def __init__(self):
        algebra, univariate, extension_field = ensure_ref_modules()
        self.BaseFieldElement = algebra.BaseFieldElement
        self.BaseField = algebra.BaseField
        self.Polynomial = univariate.Polynomial
        self.ExtensionFieldElement = extension_field.ExtensionFieldElement
        self.ExtensionField = extension_field.ExtensionField
        # canonical shared field instances (aliasing discipline)
        self.bf = self.BaseField(P)
        one = self.BaseFieldElement(1, self.bf)
        minus_one = self.BaseFieldElement(P - 1, self.bf)
        zero = self.BaseFieldElement(0, self.bf)
        self.xf = self.ExtensionField(
            self.Polynomial([one, minus_one, zero, one])
        )
        self._memo = {}

    # -- native-plain -> reference objects ------------------------------

    def _base(self, v: int):
        return self.BaseFieldElement(int(v), self.bf)

    def _xfield(self, t):
        coeffs = [int(c) for c in t]
        while coeffs and coeffs[-1] == 0:
            coeffs.pop()
        return self.ExtensionFieldElement(
            self.Polynomial([self._base(c) for c in coeffs]), self.xf
        )

    def to_ref(self, obj):
        """Convert a native-plain transcript object; container conversions
        are memoized by identity so repeated pushes of the same python
        object become pickle memo references (like the reference's repeated
        pushes of the same leaf/salt objects)."""
        if isinstance(obj, bytes):
            return obj
        if isinstance(obj, int):
            return self._base(obj)
        if isinstance(obj, tuple) and len(obj) == 3 and all(
            isinstance(c, int) for c in obj
        ):
            key = id(obj)
            if key not in self._memo:
                self._memo[key] = (self._xfield(obj), obj)
            return self._memo[key][0]
        if isinstance(obj, (tuple, list)):
            key = id(obj)
            if key not in self._memo:
                converted = type(obj)(self.to_ref(o) for o in obj)
                self._memo[key] = (converted, obj)
            return self._memo[key][0]
        raise TypeError(f"cannot convert {type(obj)} to reference format")

    # -- reference objects -> native-plain ------------------------------

    def from_ref(self, obj):
        """Convert a loaded reference object to native-plain form AND
        register the plain result in the to_ref memo pointing back at the
        ORIGINAL object. A verifier re-encoding a pulled element (for leaf
        hashing) must reproduce the prover's pickled bytes, which requires
        using the object exactly as deserialized — not a re-built one with
        different internal aliasing."""
        tn = type(obj).__name__
        if isinstance(obj, bytes):
            return obj
        if tn == "BaseFieldElement":
            return int(obj.value)
        if tn == "ExtensionFieldElement":
            cs = [int(c.value) for c in obj.polynomial.coefficients]
            cs += [0] * (3 - len(cs))
            plain = tuple(cs[:3])
            self._memo[id(plain)] = (obj, plain)
            return plain
        if isinstance(obj, (tuple, list)):
            plain = type(obj)(self.from_ref(o) for o in obj)
            self._memo[id(plain)] = (obj, plain)
            return plain
        raise TypeError(f"cannot convert {tn} from reference format")

    # -- streams ---------------------------------------------------------

    def make_stream(self) -> "RefProofStream":
        return RefProofStream(self)

    def load_stream(self, bb: bytes) -> "RefProofStream":
        ensure_ref_modules()
        ps = RefProofStream(self)
        ps.objects = pickle.loads(bb)
        return ps

    # -- merkle leaf encodings -------------------------------------------

    def leaf_payload(self, obj) -> bytes:
        """Unsalted Merkle leaf hash input (ref merkle.py:30)."""
        return pickle.dumps(self.to_ref(obj))

    def salted_payload(self, obj, salt: bytes) -> bytes:
        """Salted Merkle leaf hash input (ref salted_merkle.py:32-35)."""
        return pickle.dumps(self.to_ref(obj)) + pickle.dumps(salt)


class RefProofStream:
    """Push/pull native-plain objects; stores (and serializes) reference
    objects; Fiat-Shamir identical to ref ip.py:21-25 (default pickle
    protocol, whole-prefix hashing)."""

    def __init__(self, codec: RefCodec):
        self.codec = codec
        self.objects: List = []
        self.read_index = 0

    def push(self, obj):
        self.objects.append(self.codec.to_ref(obj))

    def pull(self):
        assert self.read_index < len(self.objects), "proof stream exhausted"
        obj = self.objects[self.read_index]
        self.read_index += 1
        return self.codec.from_ref(obj)

    def serialize(self) -> bytes:
        return pickle.dumps(self.objects)

    def prover_fiat_shamir(self, num_bytes: int = 32) -> bytes:
        return shake_256(self.serialize()).digest(num_bytes)

    def verifier_fiat_shamir(self, num_bytes: int = 32) -> bytes:
        return shake_256(
            pickle.dumps(self.objects[: self.read_index])
        ).digest(num_bytes)
