"""BrainfuckStark: the two-stage RAP prover, plain torch.

A frozen copy of the port's `protocol/stark.py` cut to its resident,
single-device, native-codec prover, on the plain field operations only.
Protocol flow and transcript order match ref `brainfuck_stark.py:20-579`
(base commit → challenges → extend → ext commit → quotients → terminals →
weights → combination commit → indices → openings → FRI); a seeded proof
is a determined byte string, the same on every path of the port, so this
prover's bytes are the yardstick a proof of the port is held to:

  - all codeword-scale math (LDE NTTs on the u64 butterfly network,
    extension scans, constraint evaluation over `ArrayAlgebra`, zerofier
    inversion, the nonlinear combination, FRI folds) runs as int64 torch
    programs on `device`, the CPU or a CUDA device alike;
  - from `device_commit_min` up every commitment is a Merkle tree hashed by
    the plain torch BLAKE2b on `device`; below it, hashlib trees.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import StarkConfig
from ..convert import tensor_to_u64, u64_to_tensor
from ..models.instruction import InstructionTable
from ..models.interp import ArrayAlgebra
from ..models.io import InputTable, OutputTable
from ..models.memory import MemoryTable
from ..models.processor import ProcessorTable
from ..models.table import roundup_npo2
from ..ops import field as f
from ..ops import ntt as nt
from ..ops import scan as sc
from ..ops import xfield as xf
from ..utils.rng import Rng
from .arguments import PermutationArgument
from .channel import (
    ProofStream,
    make_codec,
    sample_indices_stark,
    sample_weights,
)
from .device_merkle import (
    DeviceMerkle,
    DeviceSaltedMerkle,
    default_cut,
    prefetch_trees,
    prf_field_words,
    salt_key_words,
    salt_words_device,
    salt_words_to_buffer,
)
from .fri import Fri
from .merkle import Merkle, SaltBuffer, SaltedMerkle

U64 = np.uint64

# terms x rows that one step of the combination's weighing holds: each of
# its temporaries is this many F_p^3 values (2^25: 768 MiB), so that FRI
# 2^24 fits on an 80 GB card (16 terms at a time did not)
ACC_CHUNK_ELEMENTS = 1 << 25


def resolve_device(device=None) -> torch.device:
    """The prover's device: CUDA unless the caller names another. Without a
    CUDA device the default raises; it never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to prove on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _tree_sum(x):
    """Modular sum over axis 0 via log-depth halving (plain field adds)."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        rest = x[2 * half :]
        x = f.add_plain(x[:half], x[half : 2 * half])
        if rest.shape[0]:
            x = torch.cat([x, rest], dim=0)
    return x[0]


class BrainfuckStark:
    def __init__(
        self,
        running_time: int,
        memory_length: int,
        program: List[int],
        input_symbols: str,
        output_symbols: str,
        config: Optional[StarkConfig] = None,
        device=None,
    ):
        self.config = (config or StarkConfig()).validate()
        cfg = self.config
        self.device = resolve_device(device)
        self.running_time = running_time
        self.memory_length = memory_length
        self.program = list(program)
        self.input_symbols = input_symbols
        self.output_symbols = output_symbols

        nr = cfg.num_randomizers
        self.processor_table = ProcessorTable(running_time, nr)
        self.instruction_table = InstructionTable(running_time + len(program), nr)
        self.memory_table = MemoryTable(memory_length, nr)
        self.input_table = InputTable(len(input_symbols))
        self.output_table = OutputTable(len(output_symbols))
        self.tables = [
            self.processor_table,
            self.instruction_table,
            self.memory_table,
            self.input_table,
            self.output_table,
        ]

        # permutation arguments: (table, column) pairs into the extended
        # column layout (ref brainfuck_stark.py:67-72)
        self.permutation_arguments = [
            PermutationArgument(self.tables, (0, 7), (1, 3)),
            PermutationArgument(self.tables, (0, 8), (2, 4)),
        ]

        # max symbolic quotient degree over all ext transition constraints
        # with all-one challenges (ref brainfuck_stark.py:85-97)
        ones = [xf.H_ONE] * 11
        self.max_degree = 1
        for table in self.tables:
            bounds = [table.interpolant_degree()] * (2 * table.full_width)
            for air in table.symbolic_transition_constraints(ones):
                degree = air.symbolic_degree_bound(bounds) - (table.height - 1)
                self.max_degree = max(self.max_degree, degree)
        self.max_degree = roundup_npo2(self.max_degree) - 1
        fri_domain_length = (self.max_degree + 1) * cfg.expansion_factor
        self.codec = make_codec(cfg.codec)
        self.fri = Fri(
            f.GENERATOR,
            f.primitive_nth_root(fri_domain_length),
            fri_domain_length,
            cfg.expansion_factor,
            cfg.num_colinearity_checks,
            device_commit_min=cfg.device_commit_min,
            host_min=cfg.fri_host_min,
        )

    # ------------------------------------------------------------------

    def _terminals_list(self) -> List[tuple]:
        return [
            self.processor_table.terminals["instruction_permutation"],
            self.processor_table.terminals["memory_permutation"],
            self.processor_table.terminals["input_evaluation"],
            self.processor_table.terminals["output_evaluation"],
            self.instruction_table.terminals["evaluation"],
        ]

    def _base_degree_bounds(self) -> List[int]:
        out = []
        for t in self.tables:
            out += [t.interpolant_degree()] * t.base_width
        return out

    def _ext_degree_bounds(self) -> List[int]:
        out = []
        for t in self.tables:
            out += [t.interpolant_degree()] * t.num_ext_columns
        return out

    def _zerofier_inverses(self) -> Dict[int, Dict[str, object]]:
        """Per-table-height zerofier-inverse tensors over the FRI domain:
        boundary 1/(x - 1); transition (x - o^{-1})/(x^H - 1) (all-zero when
        H == 0, as ref table.py:196-199); terminal 1/(x - o^{-1}). Cached
        on the instance — they depend only on heights and the domain."""
        cache = getattr(self, "_zinv_cache", None)
        if cache is not None:
            return cache
        dev = self.device
        N = self.fri.domain.length
        omega = self.fri.domain.omega
        offset = self.fri.domain.offset
        heights = []
        for t in self.tables:
            if t.height not in heights:
                heights.append(t.height)
        omicrons = {t.height: t.omicron for t in self.tables if t.height > 0}

        def scalar(v):
            return u64_to_tensor([v], dev)

        one = f.const(1, torch.empty(0, device=dev))
        n = N
        domain = f.geometric_rows(scalar(offset), scalar(omega), n)[0]
        boundary = f.batch_inverse(f.sub(domain, one))
        out = {}
        for h in heights:
            o_inv = f.h_inverse(omicrons[h]) if h > 0 else 1
            x_minus_oinv = f.sub(domain, scalar(o_inv))
            terminal = f.batch_inverse(x_minus_oinv)
            if h > 0:
                # x^H over the coset has period N/H: invert a small table
                period = N // h
                xs = f.geometric_rows(
                    scalar(f.h_pow(offset, h)), scalar(f.h_pow(omega, h)),
                    period,
                )[0]
                sub_inv_small = f.batch_inverse(f.sub(xs, one))
                periodic = sub_inv_small.repeat(n // period)
                transition = f.mul(periodic, x_minus_oinv)
            else:
                transition = torch.zeros((n,), dtype=torch.int64, device=dev)
            out[h] = {
                "boundary": boundary,
                "transition": transition,
                "terminal": terminal,
            }
        self._zinv_cache = out
        return out

    def _device_commit(self) -> bool:
        """Whether commitments are device trees: from `device_commit_min`
        up."""
        return self.fri.domain.length >= self.config.device_commit_min

    def _lde_packs(self):
        """NTT twiddle and coset scale tables on the device, cached."""
        cache = getattr(self, "_packs_cache", None)
        if cache is not None:
            return cache
        dev = self.device
        fri = self.fri
        N = fri.domain.length
        packs = {
            "fwd": nt.make_pack(N, fri.domain.omega, False, dev),
            "rand_scale": nt.scale_table(
                fri.domain.offset, self.max_degree + 1, dev
            ),
            "tables": tuple(
                (
                    nt.make_pack(t.height, t.omicron, True, dev),
                    nt.scale_table(
                        fri.domain.offset, t.height + t.num_randomizers, dev
                    ),
                )
                if t.height > 0
                else None
                for t in self.tables
            ),
        }
        self._packs_cache = packs
        return packs

    # -- prover stages -------------------------------------------------------

    def _stage_base_lde(self, mats, rand_coeffs, base_rands, packs):
        """Randomizer codeword + per-table base codewords. All coefficient
        rows (randomizer limbs + every table's base columns) go through ONE
        shared forward NTT of the FRI domain size."""
        all_cws = self._forward_lde(
            self._stage_base_coeffs(mats, rand_coeffs, base_rands, packs),
            packs,
        )
        rand_cw = all_cws[:3].movedim(0, -1)  # (N, 3)
        base_cws = []
        pos = 3
        for t in self.tables:
            base_cws.append(all_cws[pos : pos + t.base_width])
            pos += t.base_width
        return rand_cw, tuple(base_cws)

    def _stage_base_coeffs(self, mats, rand_coeffs, base_rands, packs):
        """Offset-prescaled coefficient groups of every base commitment row
        (randomizer limbs first, then each table's base columns), in the
        zip order of the base commitment."""
        rand_coeffs = rand_coeffs.reshape(-1, 3)
        groups = [
            f.mul(rand_coeffs.movedim(-1, 0),
                  packs["rand_scale"][: rand_coeffs.shape[0]])
        ]
        for i, (t, m, r) in enumerate(zip(self.tables, mats, base_rands)):
            if t.height == 0:
                groups.append(torch.zeros((t.base_width, 1), dtype=torch.int64,
                                          device=self.device))
                continue
            tp = packs["tables"][i]
            groups.append(nt.lde_coefficients_unpadded(m.T, r, tp[0], tp[1]))
        return tuple(groups)

    def _forward_lde(self, groups, packs):
        """The shared forward NTT of an LDE stage over coefficient groups of
        different lengths (zero past their own), padded to the domain."""
        N = self.fri.domain.length
        return nt.ntt_with(
            torch.cat([nt._pad_to(g, N) for g in groups], dim=0), packs["fwd"]
        )

    def _device_extend(self, mats, challenges_arr, initials_arr):
        """All tables' extension columns as ONE batched affine scan.
        Returns (cols tuple, terms tuple), on the device."""
        all_lanes = []
        lane_slices = []
        for t, m in zip(self.tables, mats):
            lanes = t.extend_lanes(m, challenges_arr, initials_arr)
            lane_slices.append((len(all_lanes), len(all_lanes) + len(lanes)))
            all_lanes += lanes
        all_outs = sc.batched_affine_scan(all_lanes)
        cols, terms = [], []
        for (lo, hi), t, m in zip(lane_slices, self.tables, mats):
            c, tm = t.extend_finish(
                m, challenges_arr, initials_arr, all_outs[lo:hi]
            )
            cols.append(c)
            terms.append(tm)
        return tuple(cols), tuple(terms)

    def _stage_ext_lde(self, xcols, ext_rands, packs):
        """Extension LDE over the extension columns; all tables share one
        batched forward NTT like the base stage."""
        N = self.fri.domain.length
        dev = self.device
        rows = []
        layout = []  # (table_index, n_ext) in order
        for i, (t, cols, r) in enumerate(zip(self.tables, xcols, ext_rands)):
            if t.height == 0:
                layout.append((i, 0))
                continue
            tp = packs["tables"][i]
            # (H, n_ext, 3) -> (3*n_ext, H) coefficient rows
            trace = cols.movedim(0, -1)  # (n_ext, 3, H)
            trace = trace.reshape((-1, trace.shape[-1]))
            rr = None
            if r is not None:
                # (n_ext, R, 3) -> (n_ext*3, R), limb-major per column
                rr = r.movedim(-1, 1).reshape((-1, r.shape[1]))
            rows.append(nt.lde_coefficients_unpadded(trace, rr, tp[0], tp[1]))
            layout.append((i, t.num_ext_columns))
        all_cws = self._forward_lde(rows, packs)
        ext_cws = []
        pos = 0
        for i, n_ext in layout:
            t = self.tables[i]
            if t.height == 0 or n_ext == 0:
                ext_cws.append(
                    torch.zeros((t.num_ext_columns, N, 3), dtype=torch.int64,
                                device=dev)
                )
                continue
            block = all_cws[pos : pos + 3 * n_ext].reshape((n_ext, 3, N))
            ext_cws.append(block.movedim(1, -1))
            pos += 3 * n_ext
        return tuple(ext_cws)

    def _acc_group(self, acc, stack, w_pairs_g, ratios_g, opow_g,
                   chunk: int = 16):
        """acc += Σ_t (w_plain_t + w_shift_t·x^s_t)·stack[t].
        stack: (T, N) base or (T, N, 3) extension terms, or a sequence of
        such parts, the group's terms in order. The x^s rows are geometric
        progressions offset^s·(omega^s)^i. `_acc_group_plain` on each part,
        chunked (a field sum is exact, so the parts' order of summing
        changes no bit)."""
        parts = [stack] if isinstance(stack, torch.Tensor) else list(stack)
        pos = 0
        for part in parts:
            sl = slice(pos, pos + part.shape[0])
            acc = self._acc_group_plain(acc, part, w_pairs_g[sl],
                                        ratios_g[sl], opow_g[sl], chunk)
            pos = sl.stop
        return acc

    def _acc_group_plain(self, acc, stack, w_pairs_g, ratios_g, opow_g,
                         chunk: int = 16, length: Optional[int] = None):
        """`_acc_group` as torch ops on the plain field operations, `chunk`
        terms at a time, fewer where chunk x N would pass
        `ACC_CHUNK_ELEMENTS`: the x^s rows, the weighted terms and their
        tree sum as (chunk, N, 3) tensors."""
        N = length if length is not None else self.fri.domain.length
        chunk = max(1, min(chunk, ACC_CHUNK_ELEMENTS // N))
        base_stream = stack.dim() == 2
        for start in range(0, stack.shape[0], chunk):
            stop = min(start + chunk, stack.shape[0])
            xs = f.geometric_rows(opow_g[start:stop], ratios_g[start:stop], N,
                                  f.mul_plain)
            w_plain = w_pairs_g[start:stop, 0]
            w_shift = w_pairs_g[start:stop, 1]
            c = xf.mul_base_plain(
                w_shift[:, None, :].expand(stop - start, N, 3), xs)
            c = f.add_plain(c, w_plain[:, None, :])
            if base_stream:
                contrib = xf.mul_base_plain(c, stack[start:stop])
            else:
                contrib = xf.mul_plain(c, stack[start:stop])
            acc = f.add_plain(acc, _tree_sum(contrib))
        return acc

    def _quotient_combination(self, acc, base_cws, ext_cws, challenges,
                              terminals, zinvs, w_pairs, ratios, starts,
                              slots):
        """acc += the combination's quotient terms: each table's quotients
        (`Table.quotients`), then the permutation arguments' two difference
        quotients, each weighed by (w_plain + w_shift·x^s) as `_acc_group`
        weighs a group, in that order. zinvs: each table's zerofier
        inverses; w_pairs (T, 2, 3); ratios and starts (D,), the x^s
        progression of each distinct shift, and slots[t] term t's
        (`distinct_shifts`)."""
        n = int(acc.shape[0])
        index = torch.tensor(slots, device=ratios.device)
        ratios, starts = ratios[index], starts[index]
        pos = 0
        for ti in range(len(self.tables)):
            stack = self._table_quotient_stack_plain(
                ti, base_cws[ti], ext_cws[ti], challenges, terminals,
                zinvs[ti])
            sl = slice(pos, pos + stack.shape[0])
            acc = self._acc_group_plain(acc, stack, w_pairs[sl], ratios[sl],
                                        starts[sl], length=n)
            pos = sl.stop
            del stack
        # the permutation arguments' difference quotients
        boundary = zinvs[0]["boundary"]
        pa_stack = torch.stack(
            [
                xf.mul_base(xf.sub(ext_cws[0][0], ext_cws[1][0]), boundary),
                xf.mul_base(xf.sub(ext_cws[0][1], ext_cws[2][0]), boundary),
            ],
            dim=0,
        )
        assert pos + 2 == w_pairs.shape[0], "term/shift bookkeeping mismatch"
        return self._acc_group_plain(acc, pa_stack, w_pairs[pos:],
                                     ratios[pos:], starts[pos:], length=n)

    def _table_quotient_stack_plain(self, ti, base_cw, ext_cw, challenges,
                                    terminals, zinv):
        """All quotient codewords of table ti as one (T, n, 3) stack, op by
        op: `Table.quotients` over `ArrayAlgebra`, the next row a rolled
        copy of the columns."""
        t = self.tables[ti]
        alg = ArrayAlgebra(self.device)
        ch_vals = [alg.x(challenges[i]) for i in range(11)]
        tm_vals = [alg.x(terminals[i]) for i in range(5)]
        ud = t.unit_distance(self.fri.domain.length)

        def rot(arr):
            """Rows shifted by the unit distance along axis 1."""
            return torch.roll(arr, -ud, 1) if ud else arr

        base_next, ext_next = rot(base_cw), rot(ext_cw)
        point = [alg.base(base_cw[j]) for j in range(t.base_width)]
        point += [alg.x(ext_cw[j]) for j in range(t.num_ext_columns)]
        point_next = [alg.base(base_next[j]) for j in range(t.base_width)]
        point_next += [alg.x(ext_next[j]) for j in range(t.num_ext_columns)]
        q = t.quotients(alg, point, point_next, ch_vals, tm_vals, zinv)
        return torch.stack(q, dim=0)

    def _combination_pipeline(self, rand_cw, base_cws, ext_cws,
                              challenges_arr, terminals_arr, weights_h,
                              shifts, offset_pows):
        """Quotients + the weighted nonlinear combination, on the device.
        The quotient codewords never leave it: only the combination is
        committed, and the verifier recomputes quotients from openings."""
        dev = self.device
        omega = self.fri.domain.omega
        num_base = sum(t.base_width for t in self.tables)
        num_ext = sum(t.num_ext_columns for t in self.tables)
        # the base and extension terms each with its x^s progression, the
        # quotient terms with one a distinct shift (`terms`)
        q0 = num_base + num_ext
        slots, distinct = distinct_shifts(shifts[q0:])
        terms = list(range(q0)) + [q0 + slots.index(k)
                                   for k in range(len(distinct))]
        N = self.fri.domain.length
        ratios = u64_to_tensor([f.h_pow(omega, int(shifts[j])) for j in terms],
                               dev)
        opows = u64_to_tensor([offset_pows[j] for j in terms], dev)
        w0 = u64_to_tensor(weights_h[0], dev)
        w_pairs = u64_to_tensor(weights_h[1:], dev).reshape(-1, 2, 3)
        zinv = self._zerofier_inverses()

        acc = xf.mul(w0[None, :].expand(N, 3), rand_cw)
        acc = self._acc_group(acc, list(base_cws), w_pairs[:num_base],
                              ratios[:num_base], opows[:num_base])
        acc = self._acc_group(acc, list(ext_cws), w_pairs[num_base:q0],
                              ratios[num_base:q0], opows[num_base:q0])
        return self._quotient_combination(
            acc, base_cws, ext_cws, challenges_arr, terminals_arr,
            [zinv[t.height] for t in self.tables], w_pairs[q0:],
            ratios[q0:], opows[q0:], slots,
        )

    # ------------------------------------------------------------------
    # prover
    # ------------------------------------------------------------------

    def prove(
        self,
        processor_matrix: np.ndarray,
        memory_matrix: np.ndarray,
        instruction_matrix: np.ndarray,
        input_matrix: np.ndarray,
        output_matrix: np.ndarray,
        proof_stream: Optional[ProofStream] = None,
    ) -> bytes:
        cfg = self.config
        dev = self.device
        rng = Rng(cfg.seed)
        fri = self.fri
        N = fri.domain.length

        # 1. populate and pad (ref brainfuck_stark.py:139-150)
        assert len(processor_matrix) + len(self.program) == len(instruction_matrix)
        matrices = [
            processor_matrix, instruction_matrix, memory_matrix,
            input_matrix, output_matrix,
        ]
        for t, m in zip(self.tables, matrices):
            t.matrix = np.asarray(m, dtype=U64).reshape(-1, t.base_width)
            if len(t.matrix) > 0:
                t.pad()

        if proof_stream is None:
            proof_stream = self.codec.make_stream()
        mats = tuple(u64_to_tensor(t.matrix, dev) for t in self.tables)

        # 2-3. randomizer polynomial (BLAKE2b counter PRF, drawn where it is
        # consumed) + base LDE (ref :164-176)
        rand_count = (self.max_degree + 1) * 3
        randomizer_coeffs = prf_field_words(
            salt_key_words(rng.bytes(16), dev), rand_count
        )
        base_rands = tuple(
            u64_to_tensor(
                rng.base_elements((t.base_width, t.num_randomizers)), dev
            )
            if t.num_randomizers > 0 and t.height > 0
            else None
            for t in self.tables
        )
        packs = self._lde_packs()
        device_commit = self._device_commit()
        randomizer_codeword, base_codewords = self._stage_base_lde(
            mats, randomizer_coeffs, base_rands, packs
        )

        # 4. salted commitment to the zipped base codewords (ref :178-180)
        base_salt_key = rng.bytes(16)
        num_base_cols = sum(t.base_width for t in self.tables)
        base_widths = [3] + [1] * num_base_cols
        zipped_base = torch.cat(
            [randomizer_codeword] + [cw.T for cw in base_codewords], dim=1
        )  # (N, 3 + num_base_columns)
        base_tree, base_row = self._salted_commit(
            zipped_base, salt_key_words(base_salt_key, dev), base_widths
        )
        base_leaf_cache: Dict[int, tuple] = {}

        def base_leaf_obj(idx):
            if idx not in base_leaf_cache:
                base_leaf_cache[idx] = _row_to_leaf_object(
                    base_row(idx), base_widths
                )
            return base_leaf_cache[idx]

        proof_stream.push(base_tree.root())

        # 5. challenges (ref :183-184)
        challenges_h = sample_weights(11, proof_stream.prover_fiat_shamir())

        # 6. secret initials for the two permutation arguments (ref :186-187)
        initials_h = [rng.x_element(chunk=8) for _ in range(2)]

        # 7. extend tables: one batched scan on the device (ref :189-190)
        ext_rands = tuple(
            u64_to_tensor(
                rng.x_elements((t.num_ext_columns, t.num_randomizers)), dev
            )
            if t.num_randomizers > 0 and t.height > 0
            else None
            for t in self.tables
        )
        challenges_arr = u64_to_tensor(challenges_h, dev)
        initials_arr = u64_to_tensor(initials_h, dev)
        xcols, terms_dev = self._device_extend(mats, challenges_arr, initials_arr)
        for t, terms in zip(self.tables, terms_dev):
            terms = tensor_to_u64(terms)
            t.terminals = {
                n: tuple(int(v) for v in terms[j])
                for j, n in enumerate(t.terminal_names)
            }
        terminals_h = self._terminals_list()

        # 8. extension LDE (ref :194-199)
        ext_codewords = self._stage_ext_lde(xcols, ext_rands, packs)
        del xcols

        ext_salt_key = rng.bytes(16)
        num_ext_cols = sum(t.num_ext_columns for t in self.tables)
        ext_widths = [3] * num_ext_cols
        zipped_ext = torch.cat(
            [cw.movedim(0, 1).reshape(cw.shape[1], -1)
             for cw in ext_codewords],
            dim=1,
        )  # (N, 3 * num_ext_columns)
        ext_tree, ext_row = self._salted_commit(
            zipped_ext, salt_key_words(ext_salt_key, dev), ext_widths
        )
        ext_leaf_cache: Dict[int, tuple] = {}

        def ext_leaf_obj(idx):
            if idx not in ext_leaf_cache:
                ext_leaf_cache[idx] = _row_to_leaf_object(
                    ext_row(idx), ext_widths
                )
            return ext_leaf_cache[idx]

        proof_stream.push(ext_tree.root())

        # 9. quotient degree bounds (host, symbolic; ref :210-218)
        quotient_degree_bounds = []
        for t in self.tables:
            quotient_degree_bounds += t.all_quotient_degree_bounds(
                challenges_h, terminals_h)
        for pa in self.permutation_arguments:
            quotient_degree_bounds.append(pa.quotient_degree_bound())

        # 10. terminals into the transcript (ref :220-221)
        for t_ in terminals_h:
            proof_stream.push(t_)

        # 11. weights (ref :226-238)
        num_base = sum(t.base_width for t in self.tables)
        num_ext = sum(t.num_ext_columns for t in self.tables)
        num_quot = len(quotient_degree_bounds)
        weights_h = sample_weights(
            1 + 2 * (num_base + num_ext + num_quot),
            proof_stream.prover_fiat_shamir(),
        )

        # 12. quotients + nonlinear combination (ref :204-218, :240-298)
        all_shift_bounds = (
            self._base_degree_bounds() + self._ext_degree_bounds()
            + quotient_degree_bounds
        )
        shifts = [self.max_degree - b for b in all_shift_bounds]
        offset_pows = [f.h_pow(fri.domain.offset, s) for s in shifts]
        terminals_arr = u64_to_tensor(terminals_h, dev)
        combination = self._combination_pipeline(
            randomizer_codeword, base_codewords, ext_codewords,
            challenges_arr, terminals_arr, weights_h, shifts, offset_pows,
        )
        del base_codewords, ext_codewords, randomizer_codeword

        # 13. commit to the combination codeword (ref :301-302)
        if device_commit:
            combination_tree = DeviceMerkle(combination, cut=default_cut(N))
            comb_row = combination_tree.row_at
        else:
            combination = combination.cpu()
            comb_host = tensor_to_u64(combination)
            combination_tree = Merkle.from_buffer(
                comb_host.astype("<u8").tobytes(), 24, N
            )
            comb_row = lambda idx: comb_host[idx]  # noqa: E731
        comb_leaf_cache: Dict[int, tuple] = {}

        def comb_leaf_obj(idx):
            if idx not in comb_leaf_cache:
                comb_leaf_cache[idx] = tuple(int(v) for v in comb_row(idx))
            return comb_leaf_cache[idx]

        proof_stream.push(combination_tree.root())

        # 14. query indices (ref :305-307)
        indices = sample_indices_stark(
            cfg.security_level, proof_stream.prover_fiat_shamir(), N
        )
        unit_distances = list(set([t.unit_distance(N) for t in self.tables]))

        # 15. open zipped base/ext leaves (ref :313-326); device trees
        # gather all rows/salts/path siblings in one transfer
        if device_commit:
            open_idx = sorted(
                {
                    (index + d) % N
                    for index in indices
                    for d in [0] + unit_distances
                }
            )
            prefetch_trees([(base_tree, open_idx), (ext_tree, open_idx),
                            (combination_tree, indices)])
        for index in indices:
            for distance in [0] + unit_distances:
                idx = (index + distance) % N
                salt, path = base_tree.open(idx)
                proof_stream.push(base_leaf_obj(idx))
                proof_stream.push((salt, path))

                proof_stream.push(ext_leaf_obj(idx))
                proof_stream.push(ext_tree.open(idx))

        # 16. open combination codeword (ref :329-333)
        for index in indices:
            proof_stream.push(comb_leaf_obj(index))
            proof_stream.push(combination_tree.open(index))

        # 17. FRI (ref :336)
        self.fri.prove(combination, proof_stream, on_device=device_commit,
                       tree0=combination_tree)
        return proof_stream.serialize()

    def _salted_commit(self, zipped, key, widths: List[int]):
        """Salted Merkle commitment to the rows of `zipped` (N, k): a device
        tree from `device_commit_min` up, else a host hashlib tree. The
        salts come from the salt PRF on the device either way. Returns
        (tree, row accessor)."""
        N = self.fri.domain.length
        salts = salt_words_device(key, N)
        if self._device_commit():
            tree = DeviceSaltedMerkle(zipped, salts, cut=default_cut(N))
            return tree, tree.row_at
        rows = tensor_to_u64(zipped)
        salt_buf = SaltBuffer(salt_words_to_buffer(salts))
        buf, plen = _salted_payload_buffer(rows, salt_buf.buf)
        tree = SaltedMerkle.from_buffer(buf, plen, N, salt_buf)
        return tree, (lambda idx: rows[idx])


# ---------------------------------------------------------------------------


def distinct_shifts(shifts: Sequence[int]) -> Tuple[List[int], List[int]]:
    """(slots, distinct): the distinct values of `shifts` in order of first
    appearance, and each shift's index among them."""
    distinct: List[int] = []
    index: Dict[int, int] = {}
    slots = []
    for s in shifts:
        if s not in index:
            index[s] = len(distinct)
            distinct.append(s)
        slots.append(index[s])
    return slots, distinct


def _salted_payload_buffer(rows: np.ndarray, salt_buf: bytes):
    """(N, k) u64 rows + packed salts -> one contiguous payload buffer of
    per-leaf (8k + 24)-byte payloads (native-codec salted leaves)."""
    n, k = rows.shape
    row_u8 = np.ascontiguousarray(rows.astype("<u8")).view(np.uint8).reshape(
        n, 8 * k
    )
    salts_u8 = np.frombuffer(salt_buf, dtype=np.uint8).reshape(n, 24)
    return (
        np.concatenate([row_u8, salts_u8], axis=1).tobytes(),
        8 * k + 24,
    )


def _row_to_leaf_object(row: np.ndarray, widths: List[int]):
    """Rebuild the tuple-structured leaf object ((c0,c1,c2) or int per
    column) from a flat u64 row."""
    out = []
    pos = 0
    for w in widths:
        if w == 1:
            out.append(int(row[pos]))
        else:
            out.append(tuple(int(v) for v in row[pos : pos + w]))
        pos += w
    return tuple(out)
