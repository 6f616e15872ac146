"""Streamed commitments over strided codeword classes.

From FRI domains of `StarkConfig.stream_min` up, whole base and extension
codewords are never held: the prover evaluates and commits them in B
*strided classes*

    class b = { i : i ≡ b (mod B) },   block size S = N/B,

because a polynomial of degree < d restricted to a class is a plain size-S
NTT: with x_i = offset·ω^i and i = b + B·q,

    f(x_i) = Σ_k c_k·offset^k·ω^{bk}·(ω^B)^{qk}
           = NTT_S[ fold_{k mod S}( c_k·offset^k·ω^{bk} ) ](q),

ω^B being a primitive S-th root. So per class: one (1, d) geometric scale
row, a segment fold, and one batched size-S NTT; the coefficient rows (of
the trace's height, small) are the only state that persists. That NTT is
the forward LDE transform at size S, so it runs where `ntt_backend` sends
the resident one: the u64 network, or kernels B2/B3 under "mxu"
(`ops/kernel_ntt.forward_ntt`).

Merkle accumulation: adjacent leaves 2t, 2t+1 live in classes (r, r+1) at
the same position q, so taking the classes in order 0..B-1 and combining
level-k class pairs as they complete (a binary counter, at most log2(B)
pending (S, 8) digest arrays) yields the level-log2(B) digests: the
natural-order node array whose entry q covers leaves [q·B, (q+1)·B). The
upper tree is an ordinary ladder; levels below log2(B) are never stored.
Openings re-evaluate the classes (a second streaming pass), gather the
opened positions, and rebuild the pruned bottom subtrees on the host,
bit-identical to the resident tree's transcript.

Every leaf hash, salt PRF, pair combine and ladder level is a launch of
kernel B1 on the card.

The counterpart of the JAX package's `protocol/stream.py`, with the same
names. What that module does for its compiler and has no counterpart here:
classes are not grouped into one dispatch (`group_size_for` amortised a
per-dispatch cost of a remote backend; torch launches each op as it goes,
so a group would only hold more block values live) though
`StreamAccumulator.add` keeps its `level` argument for a caller that
reduces several classes first; the NTT pack and the salt key are plain
arguments, not runtime inputs kept out of an exported graph; ω^b is a
slice of a device table, not a `dynamic_slice`; the leaf indices of a class
are an `arange`, not an in-graph iota. Digests are (n, 8) int64 words, not
lo/hi u32 planes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..convert import tensor_to_u64
from ..ops import blake2b as B2
from ..ops import field as f
from ..ops import kernel_ntt as kn
from ..ops import ntt as nt
from .device_merkle import (
    _HOST_CUT,
    DeviceMerkle,
    _salt_bytes,
    leaf_digests,
    salt_key_words,
    salt_words_device,
)

U64 = np.uint64


def fold_mod(coeffs, S: int):
    """(rows, d) coefficient rows -> (rows, S) folded mod S:
    out[m] = Σ_{k ≡ m (mod S)} c_k (zero-padded past d)."""
    rows, d = int(coeffs.shape[0]), int(coeffs.shape[1])
    segs = (d + S - 1) // S
    coeffs = nt._pad_to(coeffs, segs * S)
    if segs == 1:
        return coeffs
    x = coeffs.reshape(rows, segs, S)
    acc = x[:, 0]
    for j in range(1, segs):
        acc = f.add(acc, x[:, j])
    return acc


def block_values(groups: Sequence, wb, scale_len: int, pack_S, S: int):
    """Evaluate offset-prescaled coefficient groups on strided class b.

    groups: (rows_g, d_g) int64 tensors (c_k·offset^k, the prescaling of
    `lde_coefficients_unpadded`). wb: (1,) tensor = ω^b. pack_S: the size-S
    tables of `make_stream_plan`. Returns the (Σ rows_g, S) values, groups
    concatenated, in position order q = 0..S-1 (leaf index b + B·q)."""
    one = torch.ones((1,), dtype=torch.int64, device=wb.device)
    scale = f.geometric_rows(one, wb, scale_len)[0]  # ω^{bk}
    folded = [fold_mod(f.mul(g, scale[: g.shape[1]]), S) for g in groups]
    return kn.forward_ntt(torch.cat(folded, dim=0), pack_S)


class StreamAccumulator:
    """Binary-counter Merkle accumulation over class digest blocks: feed
    class digests in order b = 0..B-1 (or digests already reduced over 2^level
    adjacent classes, at that level); at most log2(B) (S, 8) digest arrays
    are pending at any time."""

    def __init__(self):
        self.pending: Dict[int, torch.Tensor] = {}

    def add(self, digests, level: int = 0):
        lvl = level
        d = digests
        while lvl in self.pending:
            d = B2.merkle_parents_pair(self.pending.pop(lvl), d)
            lvl += 1
        self.pending[lvl] = d

    def finish(self):
        if len(self.pending) != 1:
            raise ValueError("class count must be a power of two")
        (lvl, d), = self.pending.items()
        self.pending = {}
        return lvl, d


def _ladder_levels(d):
    """Digest ladder from an (S, 8) level down to the host cut: the upper
    part of the streamed tree."""
    count = int(d.shape[0])
    levels = [d]
    while count > max(_HOST_CUT, 1):
        d = B2.merkle_parents(d)
        count //= 2
        levels.append(d)
    return tuple(levels)


class StreamedMerkle(DeviceMerkle):
    """Merkle tree whose leaf rows are not resident: built from the
    accumulator's level-log2(B) digests; openings need a `resolve()` call
    that supplies the opened leaf rows from a second streaming pass."""

    salted = False

    def __init__(self, n: int, num_classes: int, top_digests,
                 salt_key: Optional[bytes] = None):
        cut = (num_classes - 1).bit_length()
        if 1 << cut != num_classes:
            raise ValueError("class count must be a power of two")
        self.cut = cut
        self.mesh = None
        self.num_leafs = n
        self.num_classes = num_classes
        self.depth = (n - 1).bit_length()
        self.rows = None
        self.salt_words = None
        self.salt_key = salt_key
        self.levels = _ladder_levels(top_digests)
        self._finish_host_top()
        self._node_cache = {}
        self._row_cache = {}
        self._salt_cache = {}

    def resolve(self, indices, rows_for_positions):
        """Make `indices` openable. `rows_for_positions(positions)` is the
        prover's second streaming pass: it returns a host u64 array of shape
        (len(positions), B, k) whose entry [j, b] is the zipped leaf row of
        index positions[j]·B + b. Rebuilds the pruned bottom subtrees from
        those rows (and recomputed salts) on the host."""
        B = self.num_classes
        positions = sorted(
            {int(i) >> self.cut for i in indices
             if int(i) not in self._row_cache}
        )
        if not positions:
            return
        rows = np.asarray(rows_for_positions(positions), dtype=U64)
        assert rows.shape[:2] == (len(positions), B)
        leaf_idx = []
        for j, q in enumerate(positions):
            for b in range(B):
                i = q * B + b
                self._row_cache[i] = rows[j, b]
                leaf_idx.append(i)
        if self.salt_key is not None:
            words = salt_words_host(self.salt_key, leaf_idx)
            for j, i in enumerate(leaf_idx):
                self._salt_cache[i] = _salt_bytes(words[j])
        self._rebuild_bottom(leaf_idx)

    def prefetch_plan(self, indices):
        idx = sorted({int(i) for i in indices})
        missing = [i for i in idx if i not in self._row_cache]
        if missing:
            raise RuntimeError(
                "streamed tree: call resolve() before opening "
                f"(unresolved indices {missing[:4]}...)"
            )
        per_level: List[List[int]] = []
        gathered = []
        for j, level in enumerate(self.levels):
            lvl = self.cut + j
            sibs = sorted({(i >> lvl) ^ 1 for i in idx})
            sibs = [s for s in sibs if (lvl, s) not in self._node_cache]
            per_level.append(sibs)
            if sibs:
                lidx = torch.tensor(sibs, dtype=torch.int64,
                                    device=level.device)
                gathered.append(level.index_select(0, lidx))
        return ([], per_level), gathered, None


class StreamedSaltedMerkle(StreamedMerkle):
    salted = True

    def __init__(self, n, num_classes, top_digests, salt_key: bytes):
        super().__init__(n, num_classes, top_digests, salt_key=salt_key)

    def salt_at(self, index: int) -> bytes:
        return self._salt_cache[index]

    def open(self, index: int):
        return self.salt_at(index), self._path(index)


def salt_words_host(seed_bytes: bytes, indices) -> np.ndarray:
    """(len(indices), 3) u64 salt words at explicit leaf indices, on the
    host (the plain torch BLAKE2b): the few leaves `resolve` opens."""
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64))
    return tensor_to_u64(
        salt_words_device(salt_key_words(seed_bytes), len(idx), indices=idx)
    )


def _class_roots(plan, device):
    """(B,) tensor of ω^b, the per-class scale ratios."""
    return f.powers(plan["omega"], plan["B"], device)


def streamed_commit(groups, salt_key: Optional[bytes], plan):
    """First streaming pass: evaluate, hash and accumulate every class.

    groups: offset-prescaled coefficient groups (device tensors). plan:
    `make_stream_plan`'s. The zip order is the group-concatenated row order:
    leaf row b + B·q is values[:, q] of class b. Returns a
    Streamed[Salted]Merkle."""
    N, B, S = plan["N"], plan["B"], plan["S"]
    dev = groups[0].device
    scale_len = max(int(g.shape[1]) for g in groups)
    salted = salt_key is not None
    if salted:
        key = salt_key_words(salt_key, dev)
        biota = torch.arange(S, dtype=torch.int64, device=dev) * B
    wbs = _class_roots(plan, dev)
    acc = StreamAccumulator()
    for b in range(B):
        vals = block_values(groups, wbs[b : b + 1], scale_len,
                            plan["pack_S"], S)
        salts = (
            salt_words_device(key, S, indices=biota + b) if salted else None
        )
        acc.add(leaf_digests(vals.T, salts))
        del vals, salts
    lvl, top = acc.finish()
    assert lvl == (B - 1).bit_length()
    if salted:
        return StreamedSaltedMerkle(N, B, top, salt_key)
    return StreamedMerkle(N, B, top)


def reopen_rows(groups, plan):
    """Second streaming pass factory: returns rows_for_positions(positions)
    for `StreamedMerkle.resolve`. It re-evaluates every class, gathers only
    the requested positions, and brings them to the host in one copy."""
    B, S = plan["B"], plan["S"]
    dev = groups[0].device
    scale_len = max(int(g.shape[1]) for g in groups)
    wbs = _class_roots(plan, dev)

    def rows_for_positions(positions):
        pos = torch.tensor(list(positions), dtype=torch.int64, device=dev)
        per_class = []
        for b in range(B):
            vals = block_values(groups, wbs[b : b + 1], scale_len,
                                plan["pack_S"], S)
            per_class.append(vals.index_select(1, pos).T)  # (Q, k)
            del vals
        return tensor_to_u64(torch.stack(per_class, dim=1))  # (Q, B, k)

    return rows_for_positions


def make_stream_plan(N: int, B: int, omega: int, device=None,
                     kernel_ntt: bool = False):
    """Shared per-domain tables of streamed evaluation: the size-S forward
    transform with root ω^B, as a u64 pack of `ops/ntt.py` or, with
    `kernel_ntt` (the prover's `ntt_backend="mxu"`), as a four-step plan of
    kernels B2/B3."""
    S = N // B
    root = f.h_pow(omega, B)
    if kernel_ntt:
        pack_S = kn.make_kernel_plan(S, root, False, device)
    else:
        pack_S = nt.make_pack(S, root, False, device)
    return {"N": N, "B": B, "S": S, "pack_S": pack_S, "omega": omega}
