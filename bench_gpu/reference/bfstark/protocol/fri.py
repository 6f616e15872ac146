"""FRI low-degree test, the prover's side: vectorised commit/fold and query.

Protocol flow matches ref `fri.py:13-319` (iterated split-and-fold with the
(1 ± α/x)/2 combination, per-round Merkle commitments, colinearity spot
checks, explicit last-codeword interpolation), with each fold a whole-
codeword tensor map and the last-codeword degree check a coset INTT.

In this copy every fold is `ops/fold.py`'s plain torch fold where the
codeword lies: on the device while the round is at least `host_min` long
(its next tree a device tree), on the host below, where the trees are
hashlib trees. The transcript bytes are those of every path of the port.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..convert import tensor_to_u64
from ..ops import field as f
from ..ops import xfield as xf
from ..ops.fold import fold_plain
from .channel import ProofStream, sample_indices_fri
from .device_merkle import _HOST_CUT, DeviceMerkle, prefetch_trees
from .merkle import Merkle


class _DeviceTreeLeaves:
    """Leaf-object view over a device Merkle tree: tuples materialise from
    prefetched rows only at queried indices."""

    def __init__(self, tree):
        self.tree = tree

    def __len__(self):
        return self.tree.num_leafs

    def __getitem__(self, i: int) -> tuple:
        return tuple(int(v) for v in self.tree.row_at(i))


class FriDomain:
    """The coset offset·⟨omega⟩ of size `length` (ref fri.py:14-44)."""

    def __init__(self, offset: int, omega: int, length: int):
        self.offset = offset
        self.omega = omega
        self.length = length

    def __call__(self, index: int) -> int:
        return f.h_mul(f.h_pow(self.omega, index), self.offset)


class _LazyLeaves:
    """Leaf-object view over a host codeword: tuples materialise on
    indexing (objects are needed only at queried indices)."""

    def __init__(self, codeword: np.ndarray):
        self.codeword = codeword

    def __len__(self):
        return self.codeword.shape[0]

    def __getitem__(self, i: int) -> tuple:
        return tuple(int(v) for v in self.codeword[i])


def _host_tree(words: np.ndarray) -> Merkle:
    """The host tree of a round's codeword, from its u64 view."""
    return Merkle.from_buffer(
        words.astype("<u8", copy=False).tobytes(), 24, int(words.shape[0]))


class Fri:
    def __init__(
        self,
        offset: int,
        omega: int,
        initial_domain_length: int,
        expansion_factor: int,
        num_colinearity_tests: int,
        device_commit_min: int = 4096,
        host_min: Optional[int] = None,
    ):
        self.domain = FriDomain(offset, omega, initial_domain_length)
        self.expansion_factor = expansion_factor
        self.num_colinearity_tests = num_colinearity_tests
        self.device_commit_min = device_commit_min
        # rounds shorter than this run on the host even mid-device-prove
        self.host_min = max(device_commit_min, host_min or 0)
        assert self.num_rounds() >= 1, "FRI needs at least one round"

    def num_rounds(self) -> int:
        codeword_length = self.domain.length
        num = 0
        while codeword_length > self.expansion_factor:
            codeword_length //= 2
            num += 1
        return num

    # -- prover -------------------------------------------------------------

    def commit(self, codeword, proof_stream: ProofStream, on_device: bool,
               tree0=None):
        """codeword: (N, 3) int64 tensor. `on_device` selects device trees
        while rounds are at least `host_min` long. `tree0` is the caller's
        commitment to the round-0 codeword (the STARK's combination tree),
        reused instead of rebuilt. Returns (round lengths, leaf-object
        lists, trees)."""
        offset = self.domain.offset
        omega = self.domain.omega
        trees: List = []
        lengths: List[int] = []
        leaf_objs: List = []
        if not on_device:
            # every round is a host round
            codeword = codeword.cpu()

        # per-round wall time (commit side), surfaced as fri_round_s
        self.last_round_s: List[float] = []
        t_round = time.time()

        pending_tree = None  # device tree of the current codeword
        for r in range(self.num_rounds()):
            N = self.domain.length >> r
            if on_device and N < self.host_min:
                codeword = codeword.cpu()
                on_device = False
                pending_tree = None
            if r == 0 and tree0 is not None:
                tree = tree0
                objs = (
                    _DeviceTreeLeaves(tree) if on_device
                    else _LazyLeaves(tensor_to_u64(codeword))
                )
            elif pending_tree is not None:
                tree = pending_tree
                pending_tree = None
                objs = _DeviceTreeLeaves(tree)
            elif on_device:
                tree = DeviceMerkle(codeword)
                objs = _DeviceTreeLeaves(tree)
            else:
                words = tensor_to_u64(codeword)
                objs = _LazyLeaves(words)
                tree = _host_tree(words)
            if r > 0:
                proof_stream.push(tree.root())
            lengths.append(N)
            if r == self.num_rounds() - 1:
                leaf_objs.append(objs)
                break

            alpha = xf.h_sample(proof_stream.prover_fiat_shamir())
            leaf_objs.append(objs)
            trees.append(tree)

            half = N // 2
            codeword = fold_plain(codeword, alpha, omega, offset)
            if on_device and half >= self.host_min and half > _HOST_CUT:
                # the next round stays on the device: build its tree now
                pending_tree = DeviceMerkle(codeword)

            omega = f.h_mul(omega, omega)
            offset = f.h_mul(offset, offset)
            now = time.time()
            self.last_round_s.append(round(now - t_round, 4))
            t_round = now

        last = leaf_objs[-1]
        if isinstance(last, (_LazyLeaves, _DeviceTreeLeaves)):
            if isinstance(last, _DeviceTreeLeaves):
                last.tree.prefetch(range(len(last)))
            last = [last[i] for i in range(len(last))]
            leaf_objs[-1] = last
        proof_stream.push(last)
        return lengths, leaf_objs, trees

    def query(self, current_tree, next_tree, current_objs, next_objs,
              c_indices: List[int], proof_stream: ProofStream):
        a_indices = list(c_indices)
        b_indices = [i + len(current_objs) // 2 for i in c_indices]
        if hasattr(current_tree, "prefetch"):
            current_tree.prefetch(a_indices + b_indices)
        if hasattr(next_tree, "prefetch"):
            next_tree.prefetch(c_indices)
        for s in range(self.num_colinearity_tests):
            proof_stream.push(
                (
                    current_objs[a_indices[s]],
                    current_objs[b_indices[s]],
                    next_objs[c_indices[s]],
                )
            )
        for s in range(self.num_colinearity_tests):
            proof_stream.push(current_tree.open(a_indices[s]))
            proof_stream.push(current_tree.open(b_indices[s]))
            proof_stream.push(next_tree.open(c_indices[s]))

    def query_last(self, current_tree, current_objs, last_objs,
                   c_indices: List[int], proof_stream: ProofStream):
        a_indices = list(c_indices)
        b_indices = [i + len(current_objs) // 2 for i in c_indices]
        if hasattr(current_tree, "prefetch"):
            current_tree.prefetch(a_indices + b_indices)
        for s in range(self.num_colinearity_tests):
            proof_stream.push(
                (
                    current_objs[a_indices[s]],
                    current_objs[b_indices[s]],
                    last_objs[c_indices[s]],
                )
            )
        for s in range(self.num_colinearity_tests):
            proof_stream.push(current_tree.open(a_indices[s]))
            proof_stream.push(current_tree.open(b_indices[s]))

    def prove(self, codeword, proof_stream: ProofStream, on_device: bool,
              tree0=None) -> List[int]:
        assert self.domain.length == codeword.shape[0]
        lengths, leaf_objs, trees = self.commit(
            codeword, proof_stream, on_device, tree0=tree0)

        top_level_indices = sample_indices_fri(
            proof_stream.prover_fiat_shamir(),
            lengths[1] if len(lengths) > 1 else lengths[0],
            lengths[-1],
            self.num_colinearity_tests,
        )
        indices = list(top_level_indices)

        # every round's query indices are known now: gather all device
        # trees' openings in one pass
        want = {}
        probe = list(top_level_indices)
        for i in range(len(trees)):
            half = lengths[i] // 2
            probe = [idx % half for idx in probe]
            s = want.setdefault(id(trees[i]), (trees[i], set()))[1]
            s.update(probe)
            s.update(idx + half for idx in probe)
            if i + 1 < len(leaf_objs) and i + 1 < len(trees):
                s2 = want.setdefault(
                    id(trees[i + 1]), (trees[i + 1], set())
                )[1]
                s2.update(probe)
        batch = [
            (tree, sorted(idxs))
            for tree, idxs in want.values()
            if isinstance(tree, DeviceMerkle)
        ]
        if batch:
            prefetch_trees(batch)

        for i in range(len(trees) - 1):
            indices = [idx % (lengths[i] // 2) for idx in indices]
            self.query(
                trees[i], trees[i + 1], leaf_objs[i], leaf_objs[i + 1],
                indices, proof_stream,
            )
        indices = [idx % lengths[-1] for idx in indices]
        self.query_last(
            trees[-1], leaf_objs[len(trees) - 1], leaf_objs[-1], indices,
            proof_stream,
        )
        return top_level_indices
