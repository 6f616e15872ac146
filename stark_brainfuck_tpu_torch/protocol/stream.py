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
the forward LDE transform at size S, on the same kernel plan as every
other transform of the port (`ops/kernel_ntt.ntt_kernel`: B2/B3 on a CUDA
device, their plain versions on the CPU).

Merkle accumulation: adjacent leaves 2t, 2t+1 live in classes (r, r+1) at
the same position q, so taking the classes in order 0..B-1 and combining
level-k class pairs as they complete (a binary counter, at most log2(B)
pending (S, 8) digest arrays) yields the level-log2(B) digests: the
natural-order node array whose entry q covers leaves [q·B, (q+1)·B). The
upper tree is an ordinary ladder; levels below log2(B) are never stored.
Openings re-evaluate the classes (a second streaming pass), gather the
opened positions and hash their runs of B leaves again on the device,
bit-identical to the resident tree's transcript (`StreamedMerkle.resolve`).

Classes go G at a time (`group_size_for`, the JAX package's rule): the G
classes' scale rows in one doubling, one fold and one batched size-S
transform over their rows, one salt PRF and one leaf hash over their G·S leaves,
and log2(G) in-group pair levels, each one launch over all the level's
sibling pairs, before the group's digests enter the accumulator at level
log2(G) (`streamed_commit`). A group is a whole sibling subtree, so the
tree is the one class-by-class accumulation gives. The second pass
evaluates the classes G at a time too (`reopen_rows`). Every leaf hash,
salt PRF, pair combine and ladder level is a launch of kernel B1 on the
card.

The counterpart of the JAX package's `protocol/stream.py`, with the same
names and the same dispatch plan: a group of the JAX package is one
compiled dispatch, here it is the same few kernel launches at G times the
batch (B/G transforms a pass, not B). What that module does for its
compiler and has no counterpart here: the NTT pack and the salt key are
plain arguments, not runtime inputs kept out of an exported graph; ω^b is
a slice of a device table, not a `dynamic_slice`; the leaf indices of a
group are an `arange`, not an in-graph iota. Digests are (n, 8) int64
words, not lo/hi u32 planes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..convert import u64_to_tensor
from ..ops import blake2b as B2
from ..ops import field as f
from ..ops import kernel_ntt as kn
from ..ops import ntt as nt
from ..utils.metrics import count_open_runs, span, transfer
from .device_merkle import (
    _HOST_CUT,
    _NODE,
    _ROW,
    _SALT,
    DeviceMerkle,
    _fetch,
    _Piece,
    _stacked,
    _upload,
    leaf_digests,
    run_levels,
    salt_key_words,
    salt_words_device,
)


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


def group_values(groups: Sequence, wbs, scale_len: int, pack_S, S: int):
    """Evaluate offset-prescaled coefficient groups on G consecutive strided
    classes b0 .. b0+G-1.

    groups: (rows_g, d_g) int64 tensors (c_k·offset^k, the prescaling of
    `lde_coefficients_unpadded`). wbs: (G,) tensor of the classes' ω^b.
    pack_S: the size-S plan of `make_stream_plan`. Returns the
    (G, Σ rows_g, S) values, class j's block at [j], groups concatenated,
    in position order q = 0..S-1 (leaf index b0 + j + B·q)."""
    G = int(wbs.shape[0])
    ones = torch.ones((G,), dtype=torch.int64, device=wbs.device)
    scale = f.geometric_rows(ones, wbs, scale_len)  # (G, scale_len): ω^{bk}
    folded = []
    for g in groups:
        rows, d = int(g.shape[0]), int(g.shape[1])
        scaled = f.mul(g, scale[:, None, :d])  # (G, rows, d)
        folded.append(
            fold_mod(scaled.reshape(G * rows, d), S).reshape(G, rows, S))
    return kn.ntt_kernel(torch.cat(folded, dim=1), pack_S)


def block_values(groups: Sequence, wb, scale_len: int, pack_S, S: int):
    """`group_values` of one class b: wb is the (1,) tensor ω^b; returns the
    (Σ rows_g, S) values."""
    return group_values(groups, wb, scale_len, pack_S, S)[0]


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
        prover's second streaming pass: it returns the (len(positions), B,
        k) rows, a device tensor (or a host u64 array), whose entry [j, b]
        is the zipped leaf row of index positions[j]·B + b. The runs of B
        leaves are hashed on the device with their salts, and the opened
        rows, their salts and their path siblings below level log2(B) come
        to the host in one copy."""
        B, cut = self.num_classes, self.cut
        idx = sorted({int(i) for i in indices} - self._row_cache.keys())
        if not idx:
            return
        positions = sorted({i >> cut for i in idx})
        dev = self.levels[0].device
        rows = rows_for_positions(positions)
        if not torch.is_tensor(rows):
            rows = u64_to_tensor(rows, dev)
        Q = len(positions)
        assert tuple(rows.shape[:2]) == (Q, B), rows.shape
        pos = np.asarray(positions, dtype=np.int64)
        opened = np.asarray(idx, dtype=np.int64)
        # row j·B + b of the runs is leaf positions[j]·B + b
        arrays = [np.searchsorted(pos, opened >> cut) * B + (opened & (B - 1))]
        sibs = self._siblings(idx, cut)
        for lvl, at in enumerate(sibs):
            at = np.asarray(at, dtype=np.int64)
            arrays.append(_stacked(lvl, cut, Q, np.searchsorted(
                pos, at >> (cut - lvl)), at))
        if self.salt_key is not None:
            arrays.append(salt_key_words(self.salt_key).numpy())
            arrays.append(((pos[:, None] * B) + np.arange(B)).reshape(-1))
        uploaded = _upload(arrays, dev)
        rows = rows.reshape(Q * B, -1)
        salts = None
        if self.salt_key is not None:
            salts = salt_words_device(uploaded[-2], Q * B,
                                      indices=uploaded[-1])
        stack = run_levels(rows, salts, cut)
        count_open_runs(Q)
        pieces = [_Piece(self, _ROW, 0, idx, None,
                         rows.index_select(0, uploaded[0]))]
        if salts is not None:
            pieces.append(_Piece(self, _SALT, 0, idx, None,
                                 salts.index_select(0, uploaded[0])))
        for lvl in range(cut):
            pieces.append(_Piece(self, _NODE, lvl, sibs[lvl], None,
                                 stack.index_select(0, uploaded[1 + lvl])))
        _fetch(pieces)

    def prefetch_plan(self, indices):
        idx = sorted({int(i) for i in indices})
        missing = [i for i in idx if i not in self._row_cache]
        if missing:
            raise RuntimeError(
                "streamed tree: call resolve() before opening "
                f"(unresolved indices {missing[:4]}...)"
            )
        return super().prefetch_plan(idx)


class StreamedSaltedMerkle(StreamedMerkle):
    salted = True

    def __init__(self, n, num_classes, top_digests, salt_key: bytes):
        super().__init__(n, num_classes, top_digests, salt_key=salt_key)

    def salt_at(self, index: int) -> bytes:
        if index not in self._salt_cache:
            self.prefetch([index])  # raises: not resolved
        return self._salt_cache[index]

    def open(self, index: int):
        return self.salt_at(index), self._path(index)


def group_size_for(B: int, S: int, group_env: Optional[int] = None) -> int:
    """Classes a dispatch, the JAX package's rule: double while the group
    stays under B and 8 classes and the last doubling started from at most
    2^23 positions; `group_env` (a plan's "group") overrides it, capped at
    B."""
    if group_env:
        return min(group_env, B)
    g = 1
    while g < B and g < 8 and g * S <= (1 << 23):
        g *= 2
    return g


def _class_roots(plan, device):
    """(B,) tensor of ω^b, the per-class scale ratios."""
    return f.powers(plan["omega"], plan["B"], device)


def streamed_commit(groups, salt_key: Optional[bytes], plan):
    """First streaming pass: evaluate, hash and accumulate every class, G
    consecutive classes at a time (`group_size_for`).

    groups: offset-prescaled coefficient groups (device tensors). plan:
    `make_stream_plan`'s. The zip order is the group-concatenated row order:
    leaf row b + B·q is values[:, q] of class b. A group's G·S leaves are
    hashed class-major (row j·S + q is leaf b0 + j + B·q) and pair-reduced
    log2(G) levels, the sibling classes (2t, 2t+1) of a level in one
    launch, to the level-log2(G) node at each position q, over leaves
    q·B + b0 .. q·B + b0 + G - 1. Returns a Streamed[Salted]Merkle."""
    N, B, S = plan["N"], plan["B"], plan["S"]
    dev = groups[0].device
    scale_len = max(int(g.shape[1]) for g in groups)
    salted = salt_key is not None
    G = group_size_for(B, S, plan.get("group"))
    levels = (G - 1).bit_length()
    with span("commit"):
        if salted:
            key = salt_key_words(salt_key, dev)
            # the leaf indices of a group at b0 = 0, class-major
            gidx = (torch.arange(S, dtype=torch.int64, device=dev)[None, :] * B
                    + torch.arange(G, dtype=torch.int64, device=dev)[:, None])
            gidx = gidx.reshape(G * S)
        wbs = _class_roots(plan, dev)
        acc = StreamAccumulator()
        for b0 in range(0, B, G):
            vals = group_values(groups, wbs[b0 : b0 + G], scale_len,
                                plan["pack_S"], S)
            salts = (
                salt_words_device(key, G * S, indices=gidx + b0).view(G, S, 3)
                if salted else None
            )
            digests = leaf_digests(vals.transpose(1, 2), salts).view(G, S, 8)
            del vals, salts
            for _ in range(levels):
                pairs = digests.view(-1, 2, S, 8)
                digests = B2.merkle_parents_pair(pairs[:, 0], pairs[:, 1])
            acc.add(digests[0], level=levels)
        lvl, top = acc.finish()
    assert lvl == (B - 1).bit_length()
    if salted:
        return StreamedSaltedMerkle(N, B, top, salt_key)
    return StreamedMerkle(N, B, top)


def reopen_rows(groups, plan):
    """Second streaming pass factory: returns rows_for_positions(positions)
    for `StreamedMerkle.resolve`. It re-evaluates the classes G at a time
    and gathers only the requested positions: the (Q, B, k) rows, left on
    the device for `resolve` to hash."""
    B, S = plan["B"], plan["S"]
    dev = groups[0].device
    scale_len = max(int(g.shape[1]) for g in groups)
    G = group_size_for(B, S, plan.get("group"))
    wbs = _class_roots(plan, dev)

    def rows_for_positions(positions):
        pos = transfer(torch.tensor(list(positions), dtype=torch.int64), dev)
        pieces = []
        for b0 in range(0, B, G):
            vals = group_values(groups, wbs[b0 : b0 + G], scale_len,
                                plan["pack_S"], S)
            pieces.append(vals.index_select(2, pos).permute(2, 0, 1))
            del vals
        return torch.cat(pieces, dim=1)  # (Q, B, k), on the device

    return rows_for_positions


def make_stream_plan(N: int, B: int, omega: int, device=None):
    """Shared per-domain tables of streamed evaluation: the size-S forward
    transform with root ω^B, a plan of `ops/kernel_ntt.py`."""
    S = N // B
    pack_S = kn.make_kernel_plan(S, f.h_pow(omega, B), False, device)
    return {"N": N, "B": B, "S": S, "pack_S": pack_S, "omega": omega}
