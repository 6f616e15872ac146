"""FRI low-degree test: vectorised commit/fold, query, verify.

Protocol flow matches ref `fri.py:13-319` (iterated split-and-fold with the
(1 ± α/x)/2 combination, per-round Merkle commitments, colinearity spot
checks, explicit last-codeword interpolation), with each fold a whole-
codeword tensor map and the last-codeword degree check a coset INTT.

Device path: the codeword stays on the device while it is at least
`host_min` long; each round's fold runs there (`ops/fri_kernels.py`
`fold`: kernel F5 on the card, one launch a round) and the next round's
Merkle tree is built there (protocol/device_merkle.py, kernel B1 on the
card). Shorter rounds, and every round of a prove without device trees,
finish on the host: host trees, and the fold of `native/fri_host.cpp`
(`fold_host`, F5's body under g++), as the JAX package finishes them in
numpy. Only roots, query openings and the last codeword cross to the
host; the transcript bytes are the host path's.

Under the reference codec every round is folded and committed on the host:
its leaves are pickled leaf objects (`interop/refcodec.py`), and each
round keeps the list of those objects, so that a value opened twice is the
same object in the proof (a pickle memo reference), as in the JAX package.

Under a mesh (`parallel/mesh.py`) a round's codeword is in blocks, one a
rank. The fold pairs index i with i + N/2, which live half the ranks apart:
the rank that will own block j of the folded codeword pulls the two
half-blocks it needs (`Mesh.fold_pairs`), so the result is again in
contiguous blocks, and folds with 1/x_i from its block's own start.
Round trees are built in blocks. Once a round is shorter than `host_min`,
or than `MIN_BLOCK` leaves a rank, it is gathered and every rank carries on
as one device does from there. The JAX package marks each fold and its tree
with a sharding constraint and finishes small rounds through `to_host`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..convert import tensor_to_u64, u64_to_tensor
from ..ops import field as f
from ..ops import fri_kernels as fk
from ..ops import ntt as nt
from ..ops import xfield as xf
from ..utils.metrics import current, span, to_host
from .channel import ProofStream, reject, sample_indices_fri
from .device_merkle import _HOST_CUT, DeviceMerkle, prefetch_trees
from .merkle import Merkle


def _fold_device(codeword, alpha: tuple, omega: int, offset: int):
    """One fold round where the codeword lies: F5 on the card, the plain
    torch fold on the CPU; 1/x_i = offset^-1·omega^-i."""
    return fk.fold(codeword, alpha, omega, offset)


def _fold_sharded(block, alpha: tuple, omega: int, offset: int, mesh):
    """One fold round of a codeword held in blocks: `block` is this rank's
    (n, 3) of the N = n·D values, the result its (n/2, 3) of the folded
    ones, indices [rank·n/2, (rank+1)·n/2)."""
    half = int(block.shape[0]) // 2
    return fk.fold(mesh.fold_pairs(block), alpha, omega, offset,
                   start_index=mesh.rank * half)


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

    def evaluate(self, coeffs):
        """Evaluate a base-field polynomial (coeffs (d,)) on the domain
        (ref fri.py:26-30)."""
        return nt.coset_evaluate(
            coeffs[None, :], self.offset, self.omega, self.length)[0]

    def interpolate(self, values):
        """Interpolate base-field values (length,) -> coefficients
        (ref fri.py:32-34)."""
        return nt.coset_interpolate(values[None, :], self.offset, self.omega)[0]

    def xevaluate(self, xcoeffs):
        """Evaluate an extension polynomial (coeffs (d, 3)) on the domain."""
        out = nt.coset_evaluate(xcoeffs.movedim(-1, 0), self.offset,
                                self.omega, self.length)
        return out.movedim(0, -1)

    def xinterpolate(self, values):
        """Interpolate extension values (N, 3) -> coefficients (N, 3)."""
        v = values.movedim(-1, 0)
        c = nt.coset_interpolate(v, self.offset, self.omega)
        return c.movedim(0, -1)


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
        codec=None,
        device_commit_min: int = 4096,
        host_min: Optional[int] = None,
        mesh=None,
    ):
        from .channel import NativeCodec

        self.domain = FriDomain(offset, omega, initial_domain_length)
        self.expansion_factor = expansion_factor
        self.num_colinearity_tests = num_colinearity_tests
        self.codec = codec if codec is not None else NativeCodec()
        self.device_commit_min = device_commit_min
        # rounds shorter than this run on the host even mid-device-prove
        self.host_min = max(device_commit_min, host_min or 0)
        self.mesh = mesh
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
               tree0=None, sharded: bool = False, leaf_objs0=None):
        """codeword: (N, 3) int64 tensor. `on_device` selects device trees
        while rounds are at least `host_min` long. `tree0` is the caller's
        commitment to the round-0 codeword (the STARK's combination tree),
        reused instead of rebuilt. With `sharded`, `codeword` is this rank's
        block of it (and `tree0` a tree built in blocks). Under a codec other
        than the native one every round is a host tree over the codec's leaf
        payloads, and `leaf_objs0` the round-0 leaf objects (the caller's,
        so that their identity carries into the proof). Returns (round
        lengths, leaf-object lists, trees)."""
        offset = self.domain.offset
        omega = self.domain.omega
        mesh = self.mesh
        native = self.codec.name == "native"
        if not native:
            assert not (on_device or sharded or tree0 is not None), (
                "a non-native codec commits with host trees only")
        trees: List = []
        lengths: List[int] = []
        leaf_objs: List = []
        if sharded and not (on_device and self.domain.length >= self.host_min):
            codeword = mesh.all_gather(codeword)
            sharded = False
        if not on_device:
            # every round is a host round
            codeword = to_host(codeword)

        # each fold round is a span `round` of the prove in progress (its
        # seconds are `last_metrics["fri_round_s"]`); the last round, which
        # only commits, is not one
        recorder = current()
        pending_tree = None  # device tree of the current codeword
        for r in range(self.num_rounds()):
            N = self.domain.length >> r
            if recorder is not None and r < self.num_rounds() - 1:
                recorder.begin("round")
            if on_device and N < self.host_min:
                codeword = to_host(codeword)
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
                tree = DeviceMerkle(codeword, mesh=mesh if sharded else None)
                objs = _DeviceTreeLeaves(tree)
            elif native:
                words = tensor_to_u64(codeword)
                objs = _LazyLeaves(words)
                tree = _host_tree(words)
            else:
                if r == 0 and leaf_objs0 is not None:
                    objs = leaf_objs0
                else:
                    objs = [tuple(int(v) for v in row)
                            for row in tensor_to_u64(codeword)]
                tree = Merkle([self.codec.leaf_payload(o) for o in objs])
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
            if sharded:
                codeword = _fold_sharded(codeword, alpha, omega, offset, mesh)
                if half < self.host_min or not mesh.shardable(half):
                    # too short for blocks: every rank takes the whole
                    # codeword and goes on as one device does
                    codeword = mesh.all_gather(codeword)
                    sharded = False
            elif on_device:
                codeword = _fold_device(codeword, alpha, omega, offset)
            else:
                codeword = fk.fold_host(codeword, alpha, omega, offset)
            if on_device and half >= self.host_min and half > _HOST_CUT:
                # the next round stays on the device: build its tree now
                pending_tree = DeviceMerkle(
                    codeword, mesh=mesh if sharded else None)

            omega = f.h_mul(omega, omega)
            offset = f.h_mul(offset, offset)
            if recorder is not None:
                recorder.end()

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
              tree0=None, sharded: bool = False,
              leaf_objs0=None) -> List[int]:
        blocks = self.mesh.world if sharded else 1
        assert self.domain.length == codeword.shape[0] * blocks
        lengths, leaf_objs, trees = self.commit(
            codeword, proof_stream, on_device, tree0=tree0, sharded=sharded,
            leaf_objs0=leaf_objs0,
        )

        # the query phase: every round's openings gathered, then pushed
        with span("query"):
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

    # -- verifier -----------------------------------------------------------

    def verify(self, proof_stream: ProofStream, root: bytes) -> bool:
        self.last_rejection = None
        omega = self.domain.omega
        offset = self.domain.offset

        roots = [root]
        alphas = []
        for r in range(self.num_rounds()):
            if r > 0:
                roots.append(proof_stream.pull())
            alphas.append(xf.h_sample(proof_stream.verifier_fiat_shamir()))

        last_codeword = proof_stream.pull()
        payloads = [self.codec.leaf_payload(el) for el in last_codeword]
        if roots[-1] != Merkle(payloads).root():
            return reject(
                self, "FRI: last codeword does not match its Merkle root"
            )

        # low-degree check of the last codeword via coset INTT
        degree = (len(last_codeword) // self.expansion_factor) - 1
        last_omega, last_offset = omega, offset
        for _ in range(self.num_rounds() - 1):
            last_omega = f.h_mul(last_omega, last_omega)
            last_offset = f.h_mul(last_offset, last_offset)
        assert f.h_pow(last_omega, len(last_codeword)) == 1
        last_arr = u64_to_tensor(
            np.asarray(last_codeword, dtype=np.uint64).reshape(-1, 3)
        )
        coeffs = tensor_to_u64(
            FriDomain(last_offset, last_omega, len(last_codeword))
            .xinterpolate(last_arr)
        )
        if np.any(coeffs[degree + 1 :] != 0):
            nz = np.nonzero(np.any(coeffs != 0, axis=1))[0]
            return reject(
                self,
                f"FRI: last codeword has degree {int(nz[-1])}, exceeding "
                f"the bound {degree}",
            )

        top_level_indices = sample_indices_fri(
            proof_stream.verifier_fiat_shamir(),
            self.domain.length >> 1,
            self.domain.length >> (self.num_rounds() - 1),
            self.num_colinearity_tests,
        )

        for r in range(self.num_rounds() - 1):
            c_indices = [
                idx % (self.domain.length >> (r + 1)) for idx in top_level_indices
            ]
            a_indices = list(c_indices)
            b_indices = [
                idx + (self.domain.length >> (r + 1)) for idx in a_indices
            ]

            aa, bb, cc = [], [], []
            for s in range(self.num_colinearity_tests):
                ay, by, cy = proof_stream.pull()
                aa.append(ay)
                bb.append(by)
                cc.append(cy)
                ax = f.h_mul(offset, f.h_pow(omega, a_indices[s]))
                bx = f.h_mul(offset, f.h_pow(omega, b_indices[s]))
                if not _colinear(ax, ay, bx, by, alphas[r], cy):
                    return reject(
                        self,
                        f"FRI: colinearity check {s} failed in round {r} "
                        f"(indices a={a_indices[s]}, b={b_indices[s]}, "
                        f"c={c_indices[s]})",
                    )

            for s in range(self.num_colinearity_tests):
                path = proof_stream.pull()
                if not Merkle.verify(
                    roots[r], a_indices[s], path, self.codec.leaf_payload(aa[s])
                ):
                    return reject(
                        self,
                        f"FRI: Merkle path for a-leaf {a_indices[s]} "
                        f"rejected in round {r}",
                    )
                path = proof_stream.pull()
                if not Merkle.verify(
                    roots[r], b_indices[s], path, self.codec.leaf_payload(bb[s])
                ):
                    return reject(
                        self,
                        f"FRI: Merkle path for b-leaf {b_indices[s]} "
                        f"rejected in round {r}",
                    )
                if r + 1 != self.num_rounds() - 1:
                    path = proof_stream.pull()
                    if not Merkle.verify(
                        roots[r + 1], c_indices[s], path,
                        self.codec.leaf_payload(cc[s]),
                    ):
                        return reject(
                            self,
                            f"FRI: Merkle path for c-leaf {c_indices[s]} "
                            f"rejected in round {r + 1}",
                        )

            if r + 1 == self.num_rounds() - 1:
                for s in range(self.num_colinearity_tests):
                    if list(cc[s]) != [int(v) for v in last_codeword[c_indices[s]]]:
                        return reject(
                            self,
                            f"FRI: folded value at index {c_indices[s]} "
                            f"does not match the last codeword",
                        )

            omega = f.h_mul(omega, omega)
            offset = f.h_mul(offset, offset)

        return True


def _colinear(ax: int, ay: tuple, bx: int, by: tuple, cx: tuple, cy: tuple) -> bool:
    """Check (cx, cy) lies on the line through (ax, ay), (bx, by); ax/bx are
    base-field, the rest extension (ref univariate.py:190-194 semantics)."""
    dx_inv = xf.h_from_base(f.h_inverse(f.h_sub(bx, ax)))
    slope = xf.h_mul(xf.h_sub(by, ay), dx_inv)
    expected = xf.h_add(
        ay, xf.h_mul(slope, xf.h_sub(cx, xf.h_from_base(ax)))
    )
    return expected == cy
