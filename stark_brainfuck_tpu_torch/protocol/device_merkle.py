"""Device-resident Merkle trees over codeword rows.

The tree is built where the codewords live:

  - leaf payloads are rows of a device-resident (N, k) int64 tensor
    (+ device-generated 24-byte salts), hashed by `ops/blake2b.py` (kernel
    B1 on the card) — the same bytes as the native codec's
    `encode_leaf(row) [+ salt]`, so host `Merkle.verify` is unchanged;
  - parent levels are computed on the device down to `_HOST_CUT` nodes; the
    top of the tree (a few KB) is finished on the host with hashlib;
  - levels below `cut` are not kept: openings hash the 2^cut-leaf runs of
    the opened leaves again on the device, in the gather that fetches the
    openings (`prefetch_trees`; the runs of trees of one leaf shape in one
    set of launches);
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
them (a run lies in one rank's block, and that rank hashes it) and joined
in one all-gather (`prefetch_trees`), so every rank holds, and pushes, the
same objects. The JAX package reaches the same sites
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
from ..utils.metrics import count_open_runs, span, transfer

HASH_LEN = 64
_HOST_CUT = 512  # finish the tree on host once a level fits in 32 KB
# prune: don't keep digest levels below this (an opening hashes the
# 2^cut-leaf run of its leaf again on the device)
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


def run_levels(rows, salts, cut: int):
    """The pruned levels of R whole 2^cut-leaf runs: (R·2^cut, k) rows (+
    (R·2^cut, 3) salt words), run after run -> the digests of levels
    0..cut-1 of every run, one level after the other in one
    (R·(2^(cut+1) - 2), 8) tensor (`_stacked` finds a node in it). Runs
    are 2^cut-aligned, so no parent pairs the leaves of two runs."""
    d = leaf_digests(rows, salts)
    levels = [d]
    for _ in range(cut - 1):
        d = B.merkle_parents(d)
        levels.append(d)
    return torch.cat(levels) if cut > 1 else d


def _stacked(lvl: int, cut: int, runs: int, slot, pos):
    """Rows in `run_levels`' stack of `runs` runs of the level-`lvl` nodes
    `pos` (int64 arrays), whose runs are at `slot` in the stack."""
    width = 1 << (cut - lvl)
    offset = runs * ((2 << cut) - (2 << (cut - lvl)))
    return offset + slot * width + (pos & (width - 1))


def _upload(arrays: List[np.ndarray], device) -> List[torch.Tensor]:
    """Host int64 index arrays -> device tensors, in one copy."""
    if not arrays:
        return []
    flat = transfer(torch.from_numpy(np.concatenate(arrays)), device)
    return list(torch.split(flat, [len(a) for a in arrays]))


_ROW, _SALT, _NODE = range(3)


class _Piece:
    """Device rows on their way into a tree's caches: the opened rows
    (`_ROW`), their salt words (`_SALT`) or the digests of the level-`lvl`
    nodes (`_NODE`) at the sorted global `positions`. Of a sharded tree,
    `tensor` holds this rank's rows of them and `counts` how many each rank
    holds; else all of them, and `counts` is None."""

    __slots__ = ("tree", "kind", "lvl", "positions", "counts", "tensor")

    def __init__(self, tree, kind, lvl, positions, counts, tensor=None):
        self.tree = tree
        self.kind = kind
        self.lvl = lvl
        self.positions = positions
        self.counts = counts
        self.tensor = tensor

    def absorb(self, words: np.ndarray):
        """Put the (len(positions), w) host u64 words in the tree's cache."""
        tree = self.tree
        if self.kind == _ROW:
            tree._row_cache.update(zip(self.positions, words))
            return
        size = 24 if self.kind == _SALT else HASH_LEN
        buf = words.astype("<u8").tobytes()
        parts = (buf[m * size : (m + 1) * size]
                 for m in range(len(self.positions)))
        if self.kind == _SALT:
            tree._salt_cache.update(zip(self.positions, parts))
        else:
            lvl = self.lvl
            tree._node_cache.update(
                ((lvl, s), d) for s, d in zip(self.positions, parts))


def _fetch(pieces: List[_Piece]):
    """Bring the pieces' device rows to the host in one concatenated copy
    (those of sharded trees, all of one mesh: in one all-gather of what
    each rank holds) and put them in their trees' caches."""
    local = [p for p in pieces if p.counts is None]
    shared = [p for p in pieces if p.counts is not None]
    if local:
        flat_h = tensor_to_u64(torch.cat([p.tensor.reshape(-1) for p in local]))
        pos = 0
        for p in local:
            n = p.tensor.numel()
            p.absorb(flat_h[pos : pos + n].reshape(p.tensor.shape))
            pos += n
    if shared:
        mesh = shared[0].tree.mesh
        # a rank's words: its part of every piece, one after the other
        words = [sum(p.counts[r] * int(p.tensor.shape[1]) for p in shared)
                 for r in range(mesh.world)]
        flat = torch.cat([p.tensor.reshape(-1) for p in shared])
        flat_h = tensor_to_u64(
            mesh.all_gather(flat, counts=words, name="openings"))
        starts = [sum(words[:r]) for r in range(mesh.world)]
        for p in shared:
            w = int(p.tensor.shape[1])
            parts = []
            for r in range(mesh.world):
                parts.append(flat_h[starts[r] : starts[r] + p.counts[r] * w])
                starts[r] += p.counts[r] * w
            p.absorb(np.concatenate(parts).reshape(-1, w))


class DeviceMerkle:
    """Plain Merkle tree with device-side hashing: root / open like
    merkle.Merkle, plus batched `prefetch` and row access for building the
    opened leaf objects. With cut > 0 the bottom `cut` digest levels are
    pruned: an opening hashes the 2^cut-leaf run of its leaf again on the
    device (`prefetch_trees`).

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
        # a run lies in one rank's block: the rank hashes it for openings
        assert int(rows.shape[0]) >= 1 << cut, (rows.shape, cut)
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
        """What a set of leaf openings still needs: the opened leaves whose
        rows (and salts) are not held, and at each level below the host top
        the sorted path siblings not held. Returns (rows, sibs), sibs[lvl]
        the level-`lvl` siblings."""
        idx = sorted({int(i) for i in indices})
        rows = [i for i in idx if i not in self._row_cache]
        return rows, self._siblings(idx, self.cut + len(self.levels))

    def _siblings(self, idx, levels: int) -> List[List[int]]:
        """The sorted siblings not held of the leaves `idx`' paths, at each
        level below `levels`."""
        sibs = []
        for lvl in range(levels):
            want = sorted({(i >> lvl) ^ 1 for i in idx})
            sibs.append([s for s in want if (lvl, s) not in self._node_cache])
        return sibs

    def _owned(self, positions, lvl: int):
        """(local rows, counts): this rank's rows, in its level-`lvl` block,
        of the sorted global level-`lvl` `positions`, and how many of them
        each rank holds (None without a mesh)."""
        pos = np.asarray(positions, dtype=np.int64)
        if self.mesh is None:
            return pos, None
        own = int(self.rows.shape[0]) >> lvl
        first = self.first >> lvl
        counts = np.bincount(pos // own, minlength=self.mesh.world).tolist()
        return pos[(pos >= first) & (pos < first + own)] - first, counts

    def prefetch(self, indices: Iterable[int]):
        """Gather everything the given leaf openings need in one pass."""
        prefetch_trees([(self, indices)])

    def row_at(self, index: int) -> np.ndarray:
        if index not in self._row_cache:
            self.prefetch([index])
        return self._row_cache[index]

    def _path(self, index: int) -> List[bytes]:
        ndev = self.cut + len(self.levels)
        keys = [(lvl, (index >> lvl) ^ 1) for lvl in range(ndev)]
        if any(k not in self._node_cache for k in keys):
            self.prefetch([index])
        path = [self._node_cache[k] for k in keys]
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


class _RunGroup:
    """The pruned runs that trees of one leaf shape (width, salting, cut,
    device) need hashed for a batch of openings: hashed in one set of
    launches, their siblings read in one gather."""

    def __init__(self, cut: int):
        self.cut = cut
        self.members = []  # (tree, local runs, pruned sibs by level)
        self.runs = 0

    def add(self, tree, local_runs, pruned):
        self.members.append((tree, local_runs, pruned))
        self.runs += len(local_runs)

    def plan(self, arrays: List[np.ndarray]) -> List[_Piece]:
        """Append the index arrays this group uploads (each member's run
        rows, then the siblings' rows in the stack) and return the sibling
        pieces, in the order of the stack's gather."""
        cut, span_ = self.cut, np.arange(1 << self.cut, dtype=np.int64)
        for _, local_runs, _ in self.members:
            arrays.append(((local_runs[:, None] << cut) + span_).reshape(-1))
        pieces, rows, slot0 = [], [], 0
        for tree, local_runs, pruned in self.members:
            for lvl, sibs in enumerate(pruned):
                if sibs:
                    mine, counts = tree._owned(sibs, lvl)
                    slot = slot0 + np.searchsorted(local_runs,
                                                   mine >> (cut - lvl))
                    rows.append(_stacked(lvl, cut, self.runs, slot, mine))
                    pieces.append(_Piece(tree, _NODE, lvl, sibs, counts))
            slot0 += len(local_runs)
        arrays.append(np.concatenate(rows))
        return pieces

    def gather(self, uploaded: List[torch.Tensor], pieces: List[_Piece]):
        """Hash the runs (the members' rows gathered at `uploaded`' run
        rows) and fill the pieces from the stack at the last array's
        rows."""
        trees = [m[0] for m in self.members]
        run_rows, sib_rows = uploaded[:-1], uploaded[-1]
        tree = trees[0]
        if self.runs:
            rows = torch.cat([t.rows.index_select(0, r)
                              for t, r in zip(trees, run_rows)])
            salts = None
            if tree.salt_words is not None:
                salts = torch.cat([t.salt_words.index_select(0, r)
                                   for t, r in zip(trees, run_rows)])
            stack = run_levels(rows, salts, self.cut)
            count_open_runs(self.runs)
        else:
            stack = tree.levels[0].new_empty((0, 8))
        got = stack.index_select(0, sib_rows)
        sizes = [len(p.positions) if p.counts is None
                 else p.counts[p.tree.mesh.rank] for p in pieces]
        for p, t in zip(pieces, torch.split(got, sizes)):
            p.tensor = t


def prefetch_trees(pairs):
    """Batched opening prefetch across several trees: every tree's opened
    rows (+ salts) and path siblings, gathered on the device and brought to
    the host in one concatenated copy. The siblings below a tree's `cut`
    come from its 2^cut-leaf runs hashed again with B1, those of trees of
    one leaf shape in one set of launches. The index arrays go up in one
    copy too. Of sharded trees (all of one mesh) each rank gathers and
    hashes what its block holds, and one all-gather joins it."""
    arrays: List[np.ndarray] = []
    selects = []  # (source, its index array's slot, piece)
    groups: Dict[tuple, _RunGroup] = {}
    device = None

    def select(source, tree, kind, lvl, positions):
        mine, counts = tree._owned(positions, lvl)
        selects.append((source, len(arrays),
                        _Piece(tree, kind, lvl, positions, counts)))
        arrays.append(mine)

    for tree, indices in pairs:
        rows, sibs = tree.prefetch_plan(indices)
        cut = tree.cut
        if rows:
            select(tree.rows, tree, _ROW, 0, rows)
            if tree.salt_words is not None:
                select(tree.salt_words, tree, _SALT, 0, rows)
        for j, level in enumerate(tree.levels):
            if sibs[cut + j]:
                select(level, tree, _NODE, cut + j, sibs[cut + j])
        pruned = sibs[:cut]
        if any(pruned):
            runs = sorted({s >> (cut - lvl)
                           for lvl, level in enumerate(pruned)
                           for s in level})
            key = (int(tree.rows.shape[1]), tree.salt_words is not None, cut,
                   tree.rows.device)
            groups.setdefault(key, _RunGroup(cut)).add(
                tree, tree._owned(runs, cut)[0], pruned)
        if rows or any(sibs):
            assert device in (None, tree.levels[0].device)
            device = tree.levels[0].device
    plans = []
    for group in groups.values():
        first = len(arrays)
        plans.append((group, first, group.plan(arrays)))
    uploaded = _upload(arrays, device)
    pieces = []
    for source, slot, piece in selects:
        piece.tensor = source.index_select(0, uploaded[slot])
        pieces.append(piece)
    for group, first, group_pieces in plans:
        group.gather(uploaded[first : first + len(group.members) + 1],
                     group_pieces)
        pieces.extend(group_pieces)
    _fetch(pieces)


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
