"""Device-resident Merkle trees over codeword rows.

The tree is built where the codewords live:

  - leaf payloads are rows of a device-resident (N, k) int64 tensor
    (+ device-generated 24-byte salts), hashed by `ops/blake2b.py` (kernel
    B1 on the card) — the same bytes as the native codec's
    `encode_leaf(row) [+ salt]`, so host `Merkle.verify` is unchanged;
  - parent levels are computed on the device down to `_HOST_CUT` nodes; the
    top of the tree (a few KB) is finished on the host with hashlib;
  - levels below `cut` are not kept: openings recompute the bottom
    2^cut-leaf subtrees on the host from the gathered leaf rows (+salts);
  - only the root, the opened rows/salts and the sibling digests along
    opened paths cross to the host; `prefetch_trees` gathers a query set for
    several trees in one pass.

The JAX package builds trees of 2^22 leaves and more in chunks
(`BUILD_CHUNK`, there and in its FRI rounds), against the temporaries of
its compiled hash graph. The port has no counterpart: B1 reads the message
tensor and writes the digests, nothing else, and a 2^26-leaf tree was built
whole on an 80 GB card (PERF.md).

Under a mesh (`parallel/mesh.py`) a tree is built in blocks: a rank hashes
the leaves of its own block (salts drawn at its own leaf indices) and the
levels of its own subtree, down to the level that has `_HOST_CUT` nodes in
all; one all-gather joins that level, and every rank finishes the same top.
An opening's rows, salts and siblings are gathered by the ranks that own
them and joined in one all-gather (`prefetch_trees`), so every rank holds,
and pushes, the same objects. The JAX package reaches the same sites
through `to_host` (a replicate-then-read of an array the compiler
partitioned).

Salt words are (n, 3) int64 (the first three digest words of the salt PRF);
their LE bytes are the 24-byte salt, identical to the JAX package's (n, 6)
u32 layout. Tree shape matches ref merkle.py / salted_merkle.py.
"""

from __future__ import annotations

from hashlib import blake2b
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..convert import tensor_to_u64, u64_to_tensor
from ..ops import blake2b as B
from ..ops import field as f
from ..utils.metrics import span, transfer

HASH_LEN = 64
_HOST_CUT = 512  # finish the tree on host once a level fits in 32 KB
# prune: don't keep digest levels below this (bottom subtrees are
# recomputed host-side per opened leaf — 2^cut hashlib calls per query)
DEFAULT_CUT = 6


def default_cut(n: int) -> int:
    """Largest sensible prune level for an n-leaf tree: keep at least the
    levels from _HOST_CUT up on the device."""
    levels_above_host_cut = max(0, (n // (2 * _HOST_CUT)).bit_length())
    return min(DEFAULT_CUT, levels_above_host_cut)


def leaf_digests(rows, salts=None):
    """(..., k) int64 rows (+ optional (..., 3) salt words) -> (n, 8) digest
    words, n the rows' count in row-major order of the leading axes,
    bit-identical to hashlib.blake2b(encode_leaf(row) [+ salt])."""
    lead, k = tuple(rows.shape[:-1]), int(rows.shape[-1])
    nwords = k + (3 if salts is not None else 0)
    W = ((nwords + 15) // 16) * 16
    parts = [rows] if salts is None else [rows, salts]
    if W > nwords:
        parts.append(
            torch.zeros(lead + (W - nwords,), dtype=torch.int64,
                        device=rows.device)
        )
    return B.blake2b_words(torch.cat(parts, dim=-1).view(-1, W), 8 * nwords)


def build_levels(rows, salts=None, cut: int = 0, stop: int = _HOST_CUT):
    """Whole-tree build over (n, k) rows (+ salts): the digest levels from
    level `cut` up to the one of `stop` nodes (the host cut; a rank's share
    of it for a block of a sharded tree). Levels below `cut` are computed
    and dropped; `cut=0` returns the full leaf..cut ladder."""
    d = leaf_digests(rows, salts)
    count = int(rows.shape[0])
    levels = [d] if cut == 0 else []
    level = 0
    while count > max(stop, 1):
        d = B.merkle_parents(d)
        count //= 2
        level += 1
        if level >= cut:
            levels.append(d)
    assert levels, "tree too shallow for the requested cut"
    return tuple(levels)


def _prf_messages(key, ctr):
    """(n, 16) one-block messages key16 ‖ LE64(ctr), zero-padded."""
    n = int(ctr.shape[0])
    msg = torch.zeros((n, 16), dtype=torch.int64, device=ctr.device)
    msg[:, 0:2] = transfer(key, ctr.device)[None, :]
    msg[:, 2] = ctr
    return msg


def salt_words_device(key, n: int, device=None, indices=None):
    """(n, 3) int64 salt words: salt_i = blake2b(key16 ‖ LE64(i))[:24].
    key: (2,) int64 tensor of the two LE u64 key words. `indices` ((n,)
    int64 leaf indices) takes the place of the counter 0..n-1: a streamed
    commit's class covers the strided index set b + B·q."""
    if indices is None:
        ctr = torch.arange(n, dtype=torch.int64, device=device or key.device)
    else:
        if indices.dtype != torch.int64 or tuple(indices.shape) != (n,):
            raise ValueError("salt indices must be an (n,) int64 tensor")
        ctr = indices
    return B.blake2b_words(_prf_messages(key, ctr), 24)[:, :3].contiguous()


def prf_field_words(key, count: int, device=None):
    """`count` field elements from the BLAKE2b counter PRF: element 8i+j is
    digest word j of blake2b(key16 ‖ LE64(i)) taken mod p (relative bias
    ~2^-32 — blinding randomness, not transcript challenges)."""
    n_digests = (count + 7) // 8
    return prf_digest_words(key, n_digests, 0, device)[:count]


def prf_digest_words(key, n_digests: int, ctr_offset: int = 0, device=None):
    """(8·n_digests,) field words from the counter digests
    [ctr_offset, ctr_offset + n_digests)."""
    ctr = torch.arange(
        ctr_offset, ctr_offset + n_digests, dtype=torch.int64,
        device=device or key.device,
    )
    words = B.blake2b_words(_prf_messages(key, ctr), 24)
    return f.from_u64_mod_p(words.reshape(-1))


def salt_key_words(seed_bytes: bytes, device=None):
    """16-byte salt key -> (2,) int64 tensor of its two LE u64 words."""
    assert len(seed_bytes) >= 16, "salt PRF needs a 16-byte key"
    key = np.frombuffer(bytes(seed_bytes[:16]), dtype="<u8")
    return u64_to_tensor(key, device)


def salt_words_to_buffer(words) -> bytes:
    """(n, 3) int64 salt words -> packed 24·n-byte salt buffer (host)."""
    return tensor_to_u64(words).astype("<u8").tobytes()


def _salt_bytes(words_row: np.ndarray) -> bytes:
    return np.ascontiguousarray(words_row.astype("<u8")).tobytes()


def _row_payload_bytes(row: np.ndarray, salt: Optional[bytes]) -> bytes:
    """Host leaf payload: LE u64 row words (+ salt)."""
    payload = np.ascontiguousarray(row.astype("<u8")).tobytes()
    return payload + salt if salt is not None else payload


class DeviceMerkle:
    """Plain Merkle tree with device-side hashing: root / open like
    merkle.Merkle, plus batched `prefetch` and row access for building the
    opened leaf objects. With cut > 0 the bottom `cut` digest levels are
    pruned (recomputed host-side per opening).

    With `mesh`, `rows` (and `salts`, `levels`) are the rank's block of a
    tree over world·n leaves: indices stay global, each rank gathers what it
    owns, and the collectives join it (every rank must make the same
    calls)."""

    salted = False

    def __init__(self, rows, salts=None, levels=None, cut: Optional[int] = None,
                 mesh=None):
        self.mesh = mesh
        world = 1 if mesh is None else mesh.world
        n = int(rows.shape[0]) * world
        assert n & (n - 1) == 0 and n > _HOST_CUT
        if cut is None:
            cut = 0 if levels is not None else default_cut(n)
        self.cut = cut
        self.num_leafs = n
        self.depth = (n - 1).bit_length()
        self.rows = rows
        self.salt_words = salts
        # first leaf of the rank's block
        self.first = 0 if mesh is None else mesh.block(n)[0]
        if levels is None:
            with span("commit"):
                levels = build_levels(rows, salts, cut, _HOST_CUT // world)
        self.levels = tuple(levels)  # level `cut`..host-cut, on the device
        self._finish_host_top()
        self._node_cache: Dict[Tuple[int, int], bytes] = {}
        self._row_cache: Dict[int, np.ndarray] = {}
        self._salt_cache: Dict[int, bytes] = {}

    def _finish_host_top(self):
        """Read the host-cut level to the host (a span `root` of the prove
        in progress) and hash the top of the tree there."""
        with span("root"):
            top = self.levels[-1]
            if self.mesh is not None:
                top = self.mesh.all_gather(top, name="tree_top")
                assert int(top.shape[0]) == _HOST_CUT, top.shape
            digests = B.digests_to_bytes(top)
        cut = int(top.shape[0])
        nodes = bytearray(2 * cut * HASH_LEN)
        nodes[cut * HASH_LEN :] = digests
        for i in range(cut - 1, 0, -1):
            child = 2 * i * HASH_LEN
            nodes[i * HASH_LEN : (i + 1) * HASH_LEN] = blake2b(
                bytes(nodes[child : child + 2 * HASH_LEN])
            ).digest()
        self._top_nodes = nodes

    def root(self) -> bytes:
        return bytes(self._top_nodes[HASH_LEN : 2 * HASH_LEN])

    # -- openings ------------------------------------------------------------

    def prefetch_plan(self, indices: Iterable[int]):
        """Stage the device gathers a set of leaf openings needs: the
        2^cut-aligned leaf-row runs, salts, and sibling digests on the kept
        device levels. Returns (plan, device tensors, counts) for
        `prefetch_trees` and `prefetch_absorb`; under a mesh the tensors
        hold what this rank owns of each gather and `counts` how many rows
        of it each rank owns (None without a mesh)."""
        idx = sorted({int(i) for i in indices})
        cut = self.cut
        run_len = 1 << cut
        runs = sorted({i >> cut for i in idx if i not in self._row_cache})
        want_rows = [q * run_len + j for q in runs for j in range(run_len)]
        per_level: List[List[int]] = []
        for j in range(len(self.levels)):
            lvl = cut + j
            sibs = sorted({(i >> lvl) ^ 1 for i in idx})
            per_level.append(
                [s for s in sibs if (lvl, s) not in self._node_cache]
            )

        gathered, counts = [], []

        def gather(source, positions, lvl):
            """Rows `positions` (global, sorted) of a level-`lvl` array."""
            first, own = self.first >> lvl, int(source.shape[0])
            mine = [p - first for p in positions if 0 <= p - first < own]
            lidx = transfer(torch.tensor(mine, dtype=torch.int64),
                            source.device)
            gathered.append(source.index_select(0, lidx))
            if self.mesh is not None:
                per_rank = [0] * self.mesh.world
                for p in positions:
                    per_rank[p // own] += 1
                counts.append(per_rank)

        if want_rows:
            gather(self.rows, want_rows, 0)
            if self.salt_words is not None:
                gather(self.salt_words, want_rows, 0)
        for j, sibs in enumerate(per_level):
            if sibs:
                gather(self.levels[j], sibs, cut + j)
        return (want_rows, per_level), gathered, (
            counts if self.mesh is not None else None)

    def prefetch_absorb(self, plan, host):
        want_rows, per_level = plan
        pos = 0
        if want_rows:
            rows_h = host[pos]
            pos += 1
            salts_h = None
            if self.salt_words is not None:
                salts_h = host[pos]
                pos += 1
            for j, i in enumerate(want_rows):
                self._row_cache[i] = rows_h[j]
                if salts_h is not None:
                    self._salt_cache[i] = _salt_bytes(salts_h[j])
            if self.cut > 0:
                self._rebuild_bottom(want_rows)
        for j, sibs in enumerate(per_level):
            if not sibs:
                continue
            d = host[pos].astype("<u8").tobytes()
            pos += 1
            for m, s in enumerate(sibs):
                self._node_cache[(self.cut + j, s)] = (
                    d[m * HASH_LEN : (m + 1) * HASH_LEN]
                )

    def _rebuild_bottom(self, leaf_indices):
        """Recompute the pruned bottom-subtree digests (levels < cut) for
        every complete 2^cut-aligned run in `leaf_indices` (host hashlib)."""
        run_len = 1 << self.cut
        runs = sorted({i >> self.cut for i in leaf_indices})
        for q in runs:
            digs = []
            for j in range(run_len):
                i = q * run_len + j
                if i not in self._row_cache:
                    digs = None
                    break
                salt = self._salt_cache.get(i) if self.salted else None
                payload = _row_payload_bytes(self._row_cache[i], salt)
                digs.append(blake2b(payload).digest())
            if digs is None:
                continue
            pos0 = q * run_len
            for lvl in range(self.cut):
                width = run_len >> lvl
                base = pos0 >> lvl
                for m in range(width):
                    self._node_cache.setdefault((lvl, base + m), digs[m])
                digs = [
                    blake2b(digs[2 * m] + digs[2 * m + 1]).digest()
                    for m in range(width // 2)
                ]

    def prefetch(self, indices: Iterable[int]):
        """Gather everything the given leaf openings need in one pass."""
        prefetch_trees([(self, indices)])

    def _device_node(self, lvl: int, pos: int) -> bytes:
        key = (lvl, pos)
        if key not in self._node_cache:
            if lvl < self.cut:
                # pruned level: fetch the covering run and rebuild
                self.prefetch([pos << lvl])
            elif self.mesh is not None:
                # the node is the level-lvl sibling on its sibling's path
                self.prefetch([(pos ^ 1) << lvl])
            else:
                j = lvl - self.cut
                self._node_cache[key] = B.digests_to_bytes(
                    self.levels[j][pos : pos + 1]
                )
        return self._node_cache[key]

    def row_at(self, index: int) -> np.ndarray:
        if index not in self._row_cache:
            self.prefetch([index])
        return self._row_cache[index]

    def _path(self, index: int) -> List[bytes]:
        path = []
        ndev = self.cut + len(self.levels)
        for lvl in range(ndev):
            path.append(self._device_node(lvl, (index >> lvl) ^ 1))
        # host top: heap over the `cut` digest leaves; a row with c nodes
        # occupies heap[c : 2c), so node(count c, pos q) = heap[c + q]
        for lvl in range(ndev, self.depth):
            c = self.num_leafs >> lvl
            h = c + ((index >> lvl) ^ 1)
            key = ("top", h)
            if key not in self._node_cache:
                self._node_cache[key] = bytes(
                    self._top_nodes[h * HASH_LEN : (h + 1) * HASH_LEN]
                )
            path.append(self._node_cache[key])
        return path

    def open(self, index: int) -> List[bytes]:
        return self._path(index)


def prefetch_trees(pairs):
    """Batched opening prefetch across several trees: stage every tree's
    gathers, then bring them all to the host in one concatenated copy. The
    gathers of sharded trees (all of one mesh) are first joined across the
    ranks, in one all-gather of what each rank owns."""
    plans = []
    local: List = []  # (slot, tensor)
    shared: List = []  # (slot, tensor, rows of it per rank)
    mesh = None
    for tree, indices in pairs:
        plan, dev, counts = tree.prefetch_plan(indices)
        first = len(local) + len(shared)
        plans.append((tree, plan, first, len(dev)))
        for j, t in enumerate(dev):
            if counts is None:
                local.append((first + j, t))
            else:
                mesh = tree.mesh
                shared.append((first + j, t, counts[j]))
    host = [None] * (len(local) + len(shared))
    if local:
        flat_h = tensor_to_u64(torch.cat([t.reshape(-1) for _, t in local]))
        pos = 0
        for slot, t in local:
            host[slot] = flat_h[pos : pos + t.numel()].reshape(t.shape)
            pos += t.numel()
    if shared:
        # a rank's words: its part of every gather, one after the other
        words = [
            sum(c[r] * int(t.shape[1]) for _, t, c in shared)
            for r in range(mesh.world)
        ]
        flat = torch.cat([t.reshape(-1) for _, t, _ in shared])
        flat_h = tensor_to_u64(
            mesh.all_gather(flat, counts=words, name="openings"))
        starts = [sum(words[:r]) for r in range(mesh.world)]
        for slot, t, c in shared:
            w = int(t.shape[1])
            parts = []
            for r in range(mesh.world):
                parts.append(flat_h[starts[r] : starts[r] + c[r] * w])
                starts[r] += c[r] * w
            host[slot] = np.concatenate(parts).reshape(-1, w)
    for tree, plan, first, count in plans:
        tree.prefetch_absorb(plan, host[first : first + count])


class DeviceSaltedMerkle(DeviceMerkle):
    """Salted variant: a 24-byte device-generated salt appended to each leaf
    payload (ref salted_merkle.py). `open` returns (salt, path)."""

    salted = True

    def __init__(self, rows, salt_words, levels=None, cut=None, mesh=None):
        super().__init__(rows, salts=salt_words, levels=levels, cut=cut,
                         mesh=mesh)

    def salt_at(self, index: int) -> bytes:
        if index not in self._salt_cache:
            self.prefetch([index])
        return self._salt_cache[index]

    def open(self, index: int):
        return self.salt_at(index), self._path(index)
