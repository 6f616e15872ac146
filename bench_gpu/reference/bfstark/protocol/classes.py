"""The reference's second way to prove: the codewords of the three trees
evaluated class by class, for FRI domains its resident path cannot hold.

The resident path (`stark.BrainfuckStark.prove`) holds every zipped
codeword, its copies and the three whole trees at once: 57.1 GB at FRI
2^24 on an 80 GB card, and four times that at 2^26. This path holds the
coefficient rows instead. A class is the strided coset c + C·j of the
domain offset·<omega> (C classes of M = N / C points): a row's values on
class c are one M-point NTT (root omega^C) of its offset-scaled
coefficients, each a_k times omega^(c·k), folded to M terms. Each class's
leaf digests and combination values are written into whole-domain arrays;
the trees and FRI are built from those, and the rows of the opened leaves
are evaluated again from the coefficients.

Every value is the same field element as on the resident path, computed in
another order, so the proof is the same byte string. The path is built
from the reference's own plain operations, not from the program's streamed
prover, so that a fault in the program's classes, grouping or reopen is not
mirrored in its judge.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..convert import tensor_to_u64, u64_to_tensor
from ..models.interp import ArrayAlgebra
from ..ops import blake2b as B
from ..ops import field as f
from ..ops import ntt as nt
from ..ops import xfield as xf
from ..utils.rng import Rng
from .channel import sample_indices_stark, sample_weights
from .device_merkle import (
    _HOST_CUT,
    DeviceMerkle,
    DeviceSaltedMerkle,
    leaf_digests,
    prefetch_trees,
    prf_field_words,
    salt_key_words,
    salt_words_device,
)
from .stark import (
    U64,
    BrainfuckStark,
    _row_to_leaf_object,
    distinct_shifts,
)

# the largest FRI domain the resident path has proven on an 80 GB card (a
# 57.1 GB peak); above it a prove takes the class path
RESIDENT_MAX = 1 << 24

# points of a class where the caller names no class count: the program's
# streamed prover runs FRI 2^26 in 32 classes of this size
CLASS_SIZE = 1 << 21


class ClassStark(BrainfuckStark):
    """The reference prover, proving in `classes` classes (by default
    classes of `CLASS_SIZE` points) where the FRI domain is larger than
    `resident_max`, and on the resident path elsewhere."""

    def __init__(self, *args, resident_max: int = RESIDENT_MAX,
                 classes: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.resident_max = resident_max
        self.classes = classes

    def prove(self, *matrices) -> bytes:
        if self.fri.domain.length <= self.resident_max:
            return super().prove(*matrices)
        return prove_in_classes(self, *matrices, classes=self.classes)


class Classes:
    """The C strided classes of the FRI domain of `stark`, and the values
    of coefficient rows on them."""

    def __init__(self, stark: BrainfuckStark, count: Optional[int] = None):
        N = stark.fri.domain.length
        C = count or max(1, N // CLASS_SIZE)
        if C < 1 or N % C or C & (C - 1):
            raise ValueError(f"{C} classes do not split a domain of {N}")
        for t in stark.tables:
            # a table's next row must lie in the same class
            if t.height and t.unit_distance(N) % C:
                raise ValueError(f"{C} classes do not divide the unit "
                                 f"distance of a table of height {t.height}")
        self.N, self.C, self.M = N, C, N // C
        self.device = stark.device
        domain = stark.fri.domain
        self.omega, self.offset = domain.omega, domain.offset
        self.step = f.h_pow(self.omega, C)  # omega^C, the class's own root
        self.pack = nt.make_pack(self.M, self.step, False, self.device)

    def indices(self, c: int):
        """The domain indices of class c, in order."""
        return torch.arange(self.M, dtype=torch.int64,
                            device=self.device) * self.C + c

    def evaluate(self, groups, c: int):
        """(rows, M): each row of the coefficient groups (each (r, L),
        offset-scaled) at the points of class c."""
        L = max(int(g.shape[-1]) for g in groups)
        twist = f.powers(f.h_pow(self.omega, c), L, self.device)
        folded = [self._fold(f.mul(g, twist[: g.shape[-1]])) for g in groups]
        return nt.ntt_with(torch.cat(folded, dim=0), self.pack)

    def _fold(self, rows):
        """(r, L) -> (r, M): the sum of the rows' M-wide segments."""
        M = self.M
        L = int(rows.shape[-1])
        if L <= M:
            return nt._pad_to(rows, M)
        rows = nt._pad_to(rows, -(-L // M) * M)
        out = rows[:, :M]
        for s in range(M, rows.shape[-1], M):
            out = f.add(out, rows[:, s : s + M])
        return out

    def rows_at(self, groups, index):
        """(len(index), rows): the zipped rows of the groups at the domain
        indices `index` ((K,) int64), evaluated again class by class."""
        idx = [int(i) for i in index.tolist()]
        width = sum(int(g.shape[0]) for g in groups)
        out = torch.empty((len(idx), width), dtype=torch.int64,
                          device=self.device)
        for c in sorted({i % self.C for i in idx}):
            at = [p for p, i in enumerate(idx) if i % self.C == c]
            cols = torch.tensor([idx[p] // self.C for p in at],
                                device=self.device)
            out[at] = self.evaluate(groups, c)[:, cols].T
        return out

    def salted_tree(self, groups, key) -> DeviceSaltedMerkle:
        """The salted tree of the zipped rows of the groups: each class's
        leaf digests written into the whole domain's, then the levels up to
        the host cut; an opening's rows and salts are computed again."""
        digests = torch.empty((self.N, 8), dtype=torch.int64,
                              device=self.device)
        for c in range(self.C):
            salts = salt_words_device(key, self.M, indices=self.indices(c))
            digests[c :: self.C] = leaf_digests(self.evaluate(groups, c).T,
                                                salts)
        return DeviceSaltedMerkle(
            _Recomputed(self.N, self.device,
                        lambda index: self.rows_at(groups, index)),
            _Recomputed(self.N, self.device,
                        lambda index: salt_words_device(
                            key, int(index.shape[0]), indices=index)),
            levels=levels_from_leaves(digests, self.M), cut=0,
        )

    def zerofier_inverses(self, stark: BrainfuckStark, c: int):
        """`BrainfuckStark._zerofier_inverses` at the points of class c:
        per table height, boundary 1/(x - 1), transition (x - o^-1)/(x^H
        - 1) (zero where H == 0), terminal 1/(x - o^-1)."""
        dev = self.device

        def scalar(v):
            return u64_to_tensor([v], dev)

        x0 = f.h_mul(self.offset, f.h_pow(self.omega, c))
        xs = f.geometric_rows(scalar(x0), scalar(self.step), self.M)[0]
        one = f.const(1, xs)
        boundary = f.batch_inverse(f.sub(xs, one))
        out = {}
        for t in stark.tables:
            h = t.height
            if h in out:
                continue
            o_inv = f.h_inverse(t.omicron) if h > 0 else 1
            x_minus_oinv = f.sub(xs, scalar(o_inv))
            if h > 0:
                xh = f.geometric_rows(scalar(f.h_pow(x0, h)),
                                      scalar(f.h_pow(self.step, h)),
                                      self.M)[0]
                transition = f.mul(f.batch_inverse(f.sub(xh, one)),
                                   x_minus_oinv)
            else:
                transition = torch.zeros((self.M,), dtype=torch.int64,
                                         device=dev)
            out[h] = {"boundary": boundary, "transition": transition,
                      "terminal": f.batch_inverse(x_minus_oinv)}
        return out


class _Recomputed:
    """Stands in for a whole-domain (N, k) tensor that is not kept: a tree's
    gather of the opened rows (`index_select` on axis 0) computes them."""

    def __init__(self, n: int, device, rows_at):
        self.shape = (n,)
        self.device = device
        self._rows_at = rows_at

    def index_select(self, dim: int, index):
        if dim != 0:
            raise ValueError("rows are gathered along axis 0")
        return self._rows_at(index)


def levels_from_leaves(digests, block: int) -> List:
    """The digest levels of a tree from its (n, 8) leaf digests up to the
    host cut, each parent level hashed `block` parents at a time."""
    levels = [digests]
    while levels[-1].shape[0] > _HOST_CUT:
        child = levels[-1]
        n = int(child.shape[0]) // 2
        parents = torch.empty((n, 8), dtype=torch.int64, device=child.device)
        for i in range(0, n, block):
            parents[i : i + block] = B.merkle_parents(
                child[2 * i : 2 * (i + block)])
        levels.append(parents)
    return levels


def _quotient_stack(stark, ti, base_cw, ext_cw, challenges, terminals, zinv,
                    roll: int):
    """Table ti's quotients at the points of a class, as one (T, M, 3)
    stack: `Table.quotients` over `ArrayAlgebra`, the next row `roll`
    places on in the class."""
    t = stark.tables[ti]
    alg = ArrayAlgebra(stark.device)
    ch_vals = [alg.x(challenges[i]) for i in range(11)]
    tm_vals = [alg.x(terminals[i]) for i in range(5)]

    def rot(arr):
        return torch.roll(arr, -roll, 1) if roll else arr

    base_next, ext_next = rot(base_cw), rot(ext_cw)
    point = [alg.base(base_cw[j]) for j in range(t.base_width)]
    point += [alg.x(ext_cw[j]) for j in range(t.num_ext_columns)]
    point_next = [alg.base(base_next[j]) for j in range(t.base_width)]
    point_next += [alg.x(ext_next[j]) for j in range(t.num_ext_columns)]
    return torch.stack(t.quotients(alg, point, point_next, ch_vals, tm_vals,
                                   zinv), dim=0)


def _class_combination(stark, cl: Classes, c: int, base_rows, ext_rows,
                       challenges_arr, terminals_arr, weights_h, shifts,
                       offset_pows):
    """`BrainfuckStark._combination_pipeline` at the points of class c:
    (M, 3). base_rows are the zipped base rows (randomizer limbs first),
    ext_rows the zipped extension rows, both (rows, M)."""
    dev, M, tables = stark.device, cl.M, stark.tables
    rand_cw = base_rows[:3].movedim(0, -1)
    base_cws, ext_cws, pos, xpos = [], [], 3, 0
    for t in tables:
        base_cws.append(base_rows[pos : pos + t.base_width])
        pos += t.base_width
        n = t.num_ext_columns
        ext_cws.append(ext_rows[xpos : xpos + 3 * n].reshape(n, 3, M)
                       .movedim(1, -1))
        xpos += 3 * n
    num_base = sum(t.base_width for t in tables)
    q0 = num_base + sum(t.num_ext_columns for t in tables)
    slots, distinct = distinct_shifts(shifts[q0:])
    terms = list(range(q0)) + [q0 + slots.index(k)
                               for k in range(len(distinct))]
    # x^s on class c: (offset·omega^c)^s · (omega^C)^(s·j)
    ratios = u64_to_tensor([f.h_pow(cl.step, shifts[j]) for j in terms], dev)
    starts = u64_to_tensor(
        [f.h_mul(offset_pows[j], f.h_pow(cl.omega, shifts[j] * c))
         for j in terms], dev)
    w0 = u64_to_tensor(weights_h[0], dev)
    w_pairs = u64_to_tensor(weights_h[1:], dev).reshape(-1, 2, 3)

    acc = xf.mul(w0[None, :].expand(M, 3), rand_cw)
    pos = 0
    for part in base_cws + ext_cws:
        sl = slice(pos, pos + part.shape[0])
        acc = stark._acc_group_plain(acc, part, w_pairs[sl], ratios[sl],
                                     starts[sl], length=M)
        pos = sl.stop
    index = torch.tensor(slots, device=dev)
    w_q, r_q, s_q = w_pairs[q0:], ratios[q0:][index], starts[q0:][index]
    zinvs = cl.zerofier_inverses(stark, c)
    pos = 0
    for ti, t in enumerate(tables):
        stack = _quotient_stack(stark, ti, base_cws[ti], ext_cws[ti],
                                challenges_arr, terminals_arr,
                                zinvs[t.height], t.unit_distance(cl.N) // cl.C)
        sl = slice(pos, pos + stack.shape[0])
        acc = stark._acc_group_plain(acc, stack, w_q[sl], r_q[sl], s_q[sl],
                                     length=M)
        pos = sl.stop
        del stack
    boundary = zinvs[tables[0].height]["boundary"]
    pa_stack = torch.stack([
        xf.mul_base(xf.sub(ext_cws[0][0], ext_cws[1][0]), boundary),
        xf.mul_base(xf.sub(ext_cws[0][1], ext_cws[2][0]), boundary),
    ], dim=0)
    assert pos + 2 == w_q.shape[0], "term/shift bookkeeping mismatch"
    return stark._acc_group_plain(acc, pa_stack, w_q[pos:], r_q[pos:],
                                  s_q[pos:], length=M)


def prove_in_classes(stark: BrainfuckStark, processor_matrix, memory_matrix,
                     instruction_matrix, input_matrix, output_matrix,
                     classes: Optional[int] = None) -> bytes:
    """`BrainfuckStark.prove`, step for step and draw for draw, with every
    codeword evaluated in `classes` classes: the same proof bytes."""
    cfg, dev, fri = stark.config, stark.device, stark.fri
    N = fri.domain.length
    if not stark._device_commit():
        raise ValueError("the class path builds device trees: the FRI "
                         f"domain {N} is below device_commit_min")
    cl = Classes(stark, classes)
    rng = Rng(cfg.seed)
    tables = stark.tables

    # 1. populate and pad
    assert (len(processor_matrix) + len(stark.program)
            == len(instruction_matrix))
    matrices = [processor_matrix, instruction_matrix, memory_matrix,
                input_matrix, output_matrix]
    for t, m in zip(tables, matrices):
        t.matrix = np.asarray(m, dtype=U64).reshape(-1, t.base_width)
        if len(t.matrix) > 0:
            t.pad()
    proof_stream = stark.codec.make_stream()
    mats = tuple(u64_to_tensor(t.matrix, dev) for t in tables)

    # 2-3. randomizer polynomial and the base coefficient rows
    randomizer_coeffs = prf_field_words(
        salt_key_words(rng.bytes(16), dev), (stark.max_degree + 1) * 3)
    base_rands = tuple(
        u64_to_tensor(rng.base_elements((t.base_width, t.num_randomizers)),
                      dev)
        if t.num_randomizers > 0 and t.height > 0 else None
        for t in tables)
    packs = {
        "rand_scale": nt.scale_table(fri.domain.offset, stark.max_degree + 1,
                                     dev),
        "tables": tuple(
            (nt.make_pack(t.height, t.omicron, True, dev),
             nt.scale_table(fri.domain.offset, t.height + t.num_randomizers,
                            dev))
            if t.height > 0 else None
            for t in tables),
    }
    base_groups = stark._stage_base_coeffs(mats, randomizer_coeffs,
                                           base_rands, packs)

    # 4. salted commitment to the zipped base rows
    base_widths = [3] + [1] * sum(t.base_width for t in tables)
    base_tree = cl.salted_tree(base_groups,
                               salt_key_words(rng.bytes(16), dev))
    proof_stream.push(base_tree.root())

    # 5-7. challenges, the permutation arguments' initials, the extension
    challenges_h = sample_weights(11, proof_stream.prover_fiat_shamir())
    initials_h = [rng.x_element(chunk=8) for _ in range(2)]
    ext_rands = tuple(
        u64_to_tensor(rng.x_elements((t.num_ext_columns, t.num_randomizers)),
                      dev)
        if t.num_randomizers > 0 and t.height > 0 else None
        for t in tables)
    challenges_arr = u64_to_tensor(challenges_h, dev)
    xcols, terms_dev = stark._device_extend(mats, challenges_arr,
                                            u64_to_tensor(initials_h, dev))
    for t, terms in zip(tables, terms_dev):
        terms = tensor_to_u64(terms)
        t.terminals = {n: tuple(int(v) for v in terms[j])
                       for j, n in enumerate(t.terminal_names)}
    terminals_h = stark._terminals_list()

    # 8. the extension coefficient rows (limb-major a column, as zipped)
    # and their salted commitment
    ext_groups = []
    for i, (t, cols, r) in enumerate(zip(tables, xcols, ext_rands)):
        if t.height == 0:
            ext_groups.append(torch.zeros((3 * t.num_ext_columns, 1),
                                          dtype=torch.int64, device=dev))
            continue
        trace = cols.movedim(0, -1)
        trace = trace.reshape((-1, trace.shape[-1]))
        rr = None if r is None else r.movedim(-1, 1).reshape((-1, r.shape[1]))
        tp = packs["tables"][i]
        ext_groups.append(nt.lde_coefficients_unpadded(trace, rr, tp[0],
                                                       tp[1]))
    del xcols
    ext_widths = [3] * sum(t.num_ext_columns for t in tables)
    ext_tree = cl.salted_tree(ext_groups, salt_key_words(rng.bytes(16), dev))
    proof_stream.push(ext_tree.root())

    # 9-11. quotient degree bounds, terminals, weights
    quotient_degree_bounds = []
    for t in tables:
        quotient_degree_bounds += t.all_quotient_degree_bounds(challenges_h,
                                                               terminals_h)
    for pa in stark.permutation_arguments:
        quotient_degree_bounds.append(pa.quotient_degree_bound())
    for t_ in terminals_h:
        proof_stream.push(t_)
    num_terms = (sum(t.base_width for t in tables)
                 + sum(t.num_ext_columns for t in tables)
                 + len(quotient_degree_bounds))
    weights_h = sample_weights(1 + 2 * num_terms,
                               proof_stream.prover_fiat_shamir())

    # 12-13. the combination class by class, and its tree
    shifts = [stark.max_degree - b for b in
              stark._base_degree_bounds() + stark._ext_degree_bounds()
              + quotient_degree_bounds]
    offset_pows = [f.h_pow(fri.domain.offset, s) for s in shifts]
    terminals_arr = u64_to_tensor(terminals_h, dev)
    combination = torch.empty((N, 3), dtype=torch.int64, device=dev)
    digests = torch.empty((N, 8), dtype=torch.int64, device=dev)
    for c in range(cl.C):
        values = _class_combination(
            stark, cl, c, cl.evaluate(base_groups, c),
            cl.evaluate(ext_groups, c), challenges_arr, terminals_arr,
            weights_h, shifts, offset_pows)
        combination[c :: cl.C] = values
        digests[c :: cl.C] = leaf_digests(values)
    combination_tree = DeviceMerkle(
        combination, levels=levels_from_leaves(digests, cl.M), cut=0)
    del digests
    proof_stream.push(combination_tree.root())

    # 14. query indices
    indices = sample_indices_stark(cfg.security_level,
                                   proof_stream.prover_fiat_shamir(), N)
    unit_distances = list(set([t.unit_distance(N) for t in tables]))

    # 15-16. open the zipped base and extension leaves, then the
    # combination's
    open_idx = sorted({(index + d) % N for index in indices
                       for d in [0] + unit_distances})
    prefetch_trees([(base_tree, open_idx), (ext_tree, open_idx),
                    (combination_tree, indices)])
    leaves: Dict[tuple, tuple] = {}

    def leaf(tree, widths, idx):
        key = (id(tree), idx)
        if key not in leaves:
            row = tree.row_at(idx)
            leaves[key] = (_row_to_leaf_object(row, widths) if widths
                           else tuple(int(v) for v in row))
        return leaves[key]

    for index in indices:
        for distance in [0] + unit_distances:
            idx = (index + distance) % N
            salt, path = base_tree.open(idx)
            proof_stream.push(leaf(base_tree, base_widths, idx))
            proof_stream.push((salt, path))
            proof_stream.push(leaf(ext_tree, ext_widths, idx))
            proof_stream.push(ext_tree.open(idx))
    for index in indices:
        proof_stream.push(leaf(combination_tree, None, index))
        proof_stream.push(combination_tree.open(index))

    # 17. FRI
    fri.prove(combination, proof_stream, on_device=True,
              tree0=combination_tree)
    return proof_stream.serialize()
