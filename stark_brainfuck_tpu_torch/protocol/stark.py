"""BrainfuckStark: the two-stage RAP prover/verifier orchestration, on torch.

Protocol flow and transcript order match ref `brainfuck_stark.py:20-579`
(base commit → challenges → extend → ext commit → quotients → terminals →
weights → combination commit → indices → openings → FRI), and a seeded
proof is byte-identical to the JAX package's, under either codec, on one
device or, with `mesh_shape`, on the ranks of a `torch.distributed` process
group:

  - all codeword-scale math (LDE NTTs, extension scans, constraint
    evaluation, zerofier inversion, nonlinear combination, FRI folds) runs
    as int64 tensor programs on `device` (CUDA unless the caller asks for
    the CPU); every LDE transform, the tables' INTTs and the forward NTT of
    both stages or of every streamed class, is the four-step transform of
    `ops/kernel_ntt.py`: kernels B2/B3 on a CUDA device, their plain
    versions on the CPU, whatever `ntt_backend` says;
  - from `device_commit_min` up, every commitment is a device Merkle tree
    hashed by kernel B1; below it the trees are built on the host;
  - from FRI domains of `stream_min` up the prover is streamed: whole base
    and extension codewords never exist, only their coefficient rows;
    commitments, the combination and the openings are computed per strided
    class (`protocol/stream.py`), with the same transcript bytes;
  - with `StarkConfig(mesh_shape=(("shard", D),))` every rank of the
    process group runs this same `prove` (one process per rank, the same
    seeded host logic and transcript) and holds the block
    [rank·N/D, (rank+1)·N/D) of every codeword: the LDE is the distributed
    four-step NTT (`parallel/dntt.py`), the zerofier rows and x^s rows
    start at the block's own domain point, the transition's row shift is a
    roll across ranks, commitments are trees built in blocks
    (`protocol/device_merkle.py`) and FRI folds pull their pairs
    (`protocol/fri.py`); trace-height work is replicated. Every rank
    returns the same bytes as one device does. Where the JAX package marks
    arrays with `_shard` and lets its compiler insert the collectives, each
    exchange here is a call into `parallel/mesh.py`;
  - under the reference codec (`codec="ref"`, `interop/refcodec.py`) the
    codewords are computed on the device as above, but every tree hashes
    pickled leaf objects on the host, FRI folds on the host, nothing
    streams, and the ranks of a mesh gather before they commit. The prover
    shares leaf objects where the JAX package's does (the leaf caches,
    FRI round 0 opening the combination leaves), because the pickle's memo
    references are part of the bytes;
  - `debug_degree_checks` (the reference's DEBUG mode) interpolates every
    quotient on CPU copies of the resident codewords and checks its degree;
  - the verifier recomputes the quotients with the same constraint
    builders over CPU tensors (one lane per query index);
  - hashing of transcript objects stays on the host.

The JAX package's export cache (`utils/aot.py`, which keeps its compiled
stages across processes) has no counterpart: nothing here is compiled
ahead of a prove; the CUDA kernels are built once per source by
`ops/cuda_build.py`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

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
from ..ops import field_kernels as fk
from ..ops import kernel_ntt as kn
from ..ops import ntt as nt
from ..ops import quotient_kernels as qk
from ..ops import scan as sc
from ..ops import xfield as xf
from ..parallel import dntt as dn
from ..parallel.mesh import codeword_block, make_mesh, mesh_size
from ..utils.checkpoint import (
    load_commit_stage,
    proof_key,
    save_commit_stage,
)
from ..utils.metrics import SpanRecorder, span, to_host, transfer
from ..utils.rng import Rng
from .arguments import (
    PermutationArgument,
    evaluation_terminal,
    program_evaluation_terminal,
)
from .channel import (
    ProofStream,
    make_codec,
    reject,
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
from .merkle import NATIVE_MIN_LEAVES, Merkle, SaltBuffer, SaltedMerkle
from .stream import (
    StreamedSaltedMerkle,
    block_values,
    group_size_for,
    make_stream_plan,
    reopen_rows,
    streamed_commit,
)

U64 = np.uint64


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
        # a mesh of one rank is the single-device prover; a larger one must
        # be the initialised process group, and gives the rank its device
        ranks = mesh_size(cfg.mesh_shape)
        self.mesh = make_mesh(ranks, device=device) if ranks > 1 else None
        self.device = (resolve_device(device) if self.mesh is None
                       else self.mesh.device)
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
        # the streamed prover takes over from here up, under the native codec
        # (the reference codec's trees hash pickled leaf objects on the host,
        # so it stays resident, as in the JAX package)
        self.use_stream = (cfg.codec == "native"
                           and fri_domain_length >= cfg.stream_min)
        if self.mesh is not None and self.use_stream:
            raise ValueError(
                f"mesh_shape with a streamed domain ({fri_domain_length} >= "
                f"stream_min {cfg.stream_min}): the streamed prover is not "
                f"partitioned over a mesh"
            )
        self.last_commit_resumes: List[str] = []

        self.codec = make_codec(cfg.codec)
        self.fri = Fri(
            f.GENERATOR,
            f.primitive_nth_root(fri_domain_length),
            fri_domain_length,
            cfg.expansion_factor,
            cfg.num_colinearity_checks,
            codec=self.codec,
            device_commit_min=cfg.device_commit_min,
            host_min=cfg.fri_host_min,
            mesh=self.mesh,
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
        on the instance — they depend only on heights and the domain. Under
        a mesh, the rank's block of each: the domain slice starts at
        offset·ω^lo, and the periodic table is cut or repeated to it."""
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
        lo, n = self._block()
        domain = f.geometric_rows(
            scalar(f.h_mul(offset, f.h_pow(omega, lo))), scalar(omega), n
        )[0]
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
                if period <= n:
                    periodic = sub_inv_small.repeat(n // period)
                else:
                    periodic = sub_inv_small[lo % period :][:n]
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

    def debug_check_degrees(self, base_cws, ext_cws, challenges_h,
                            terminals_h):
        """The reference's DEBUG mode (table.py:170-176, 219-234, 264-284):
        interpolate every quotient codeword and assert its degree is below
        both the FRI domain bound and its symbolic degree bound. On CPU
        copies of the codewords (gathered from the ranks under a mesh);
        gated by StarkConfig.debug_degree_checks. As the JAX package's
        `debug_check_degrees`."""
        mesh = self.mesh

        def whole(x, dim):
            return to_host(x if mesh is None else mesh.all_gather(x, dim=dim))

        alg = ArrayAlgebra("cpu")
        N = self.fri.domain.length
        ch_vals = [alg.x(u64_to_tensor(c)) for c in challenges_h]
        tm_vals = [alg.x(u64_to_tensor(t_)) for t_ in terminals_h]
        zinv = {h: {k: whole(v, 0) for k, v in kinds.items()}
                for h, kinds in self._zerofier_inverses().items()}
        for t, base_cw, ext_cw in zip(self.tables, base_cws, ext_cws):
            base_cw, ext_cw = whole(base_cw, 1), whole(ext_cw, 1)
            ud = t.unit_distance(N)
            point = [alg.base(base_cw[j]) for j in range(t.base_width)]
            point += [alg.x(ext_cw[j]) for j in range(t.num_ext_columns)]
            point_next = [alg.base(torch.roll(base_cw[j], -ud, 0))
                          for j in range(t.base_width)]
            point_next += [alg.x(torch.roll(ext_cw[j], -ud, 0))
                           for j in range(t.num_ext_columns)]
            quotients = t.quotients(
                alg, point, point_next, ch_vals, tm_vals, zinv[t.height]
            )
            bounds = t.all_quotient_degree_bounds(challenges_h, terminals_h)
            for i, (q, bound) in enumerate(zip(quotients, bounds)):
                coeffs = self.fri.domain.xinterpolate(q)
                nz = torch.nonzero((coeffs != 0).any(dim=1))
                deg = int(nz[-1]) if len(nz) else -1
                assert deg < N - 1, (
                    f"{t.name} quotient {i}: degree {deg} hits the domain "
                    f"bound — AIR does not divide cleanly"
                )
                assert deg <= bound or deg == -1, (
                    f"{t.name} quotient {i}: degree {deg} > symbolic bound "
                    f"{bound}"
                )

    def _block(self):
        """(first index, length) of this rank's block of the FRI domain:
        the whole domain without a mesh."""
        N = self.fri.domain.length
        if self.mesh is None:
            return 0, N
        lo, hi = self.mesh.block(N)
        return lo, hi - lo

    def _device_commit(self) -> bool:
        """Whether commitments are device trees: from `device_commit_min`
        up, under the native codec. The reference codec hashes pickled leaf
        objects, so its trees are always built on the host."""
        return (self.codec.name == "native"
                and self.fri.domain.length >= self.config.device_commit_min)

    def _sharded_commit(self) -> bool:
        """Whether commitments are trees built in blocks: under a mesh, with
        device trees, while each rank keeps enough leaves. Else the codeword
        is gathered and every rank builds the whole tree."""
        return (self.mesh is not None and self._device_commit()
                and self.mesh.shardable(self.fri.domain.length))

    def _ntt_path(self) -> str:
        """The route of every transform, which the device alone decides:
        kernels B2/B3 on a CUDA device, their plain versions elsewhere.
        Under a mesh the same names the local route of the distributed
        transform's two DFTs."""
        return ("four-step-cuda" if self.device.type == "cuda"
                else "four-step-plain")

    def _mesh_ntt_path(self) -> str:
        """`_ntt_path`, with what a mesh adds: `dntt-mesh` for the
        distributed four-step transform, or `replicated` where the ranks do
        not divide both of its factors and, as in the JAX package, every
        rank runs the single-device transform (and keeps its block)."""
        if self.mesh is None:
            return self._ntt_path()
        how = ("dntt-mesh" if dn.divides(self.fri.domain.length,
                                         self.mesh.world) else "replicated")
        return f"{how}:{self._ntt_path()}"

    def _lde_packs(self):
        """NTT plans and coset scale tables on the device, built once per
        prover: the forward N-point plan (or a mesh rank's tables of the
        distributed transform) and each table's INTT plan."""
        cache = getattr(self, "_packs_cache", None)
        if cache is not None:
            return cache
        dev = self.device
        fri = self.fri
        N = fri.domain.length
        # a streamed prove runs no N-point transform (size-S class NTTs and
        # height-sized INTTs only): its tables are `_stream_plan`'s
        fwd = dntt = None
        if self.mesh is not None and dn.divides(N, self.mesh.world):
            # the rank's tables of the distributed transform: no N-point
            # plan and no N-word twiddle table (a mesh never streams)
            dntt = dn.make_dntt_tables(N, fri.domain.omega, self.mesh, dev)
        elif not self.use_stream:
            # the kernel plan covers every domain up to 2^26 (or raises)
            fwd = kn.make_kernel_plan(N, fri.domain.omega, False, dev)
        packs = {
            "fwd": fwd,
            "dntt": dntt,
            "rand_scale": nt.scale_table(
                fri.domain.offset, self.max_degree + 1, dev
            ),
            "tables": tuple(
                (
                    kn.make_kernel_plan(t.height, t.omicron, True, dev),
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

    def _forward_lde(self, groups, packs):
        """The shared forward NTT of an LDE stage over coefficient groups of
        different lengths (zero past their own): on one device the groups
        are padded to the domain and go through `ntt_kernel`; under a mesh
        they go through the distributed transform and the rank's block
        (rows, N/D) comes back."""
        N = self.fri.domain.length
        if packs["dntt"] is not None:
            return dn.distributed_ntt_with(groups, packs["dntt"], self.mesh)
        all_cws = kn.ntt_kernel(
            torch.cat([nt._pad_to(g, N) for g in groups], dim=0), packs["fwd"]
        )
        return codeword_block(self.mesh, all_cws, 1).contiguous()

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
        _, N = self._block()  # the rank's block under a mesh
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
                   chunk: int = 16, length: Optional[int] = None):
        """acc += Σ_t (w_plain_t + w_shift_t·x^s_t)·stack[t].
        stack: (T, N) base or (T, N, 3) extension terms, or a sequence of
        such parts, the group's terms in order (columns of the LDE tensors,
        read where they lie). The x^s rows are geometric progressions
        offset^s·(omega^s)^i. `length` takes N's place for the streamed,
        per-class accumulation, where opow_g holds the class's starts
        (offset·ω^b)^s and ratios_g the per-position ratios (ω^B)^s. On a
        CUDA device one launch of kernel F3 (`field_kernels.acc_group`,
        after one of its power tables), which updates acc in place and
        makes no (T, N, 3) temporary; on the
        CPU `_acc_group_plain` on each part, chunked (a field sum is exact,
        so the parts' order of summing changes no bit)."""
        N = length if length is not None else self.fri.domain.length
        parts = [stack] if isinstance(stack, torch.Tensor) else list(stack)
        if fk.card_device(acc, *parts) is not None:
            return fk.acc_group(acc, parts, w_pairs_g, ratios_g, opow_g, N)
        pos = 0
        for part in parts:
            sl = slice(pos, pos + part.shape[0])
            acc = self._acc_group_plain(acc, part, w_pairs_g[sl],
                                        ratios_g[sl], opow_g[sl], chunk, N)
            pos = sl.stop
        return acc

    def _acc_group_plain(self, acc, stack, w_pairs_g, ratios_g, opow_g,
                         chunk: int = 16, length: Optional[int] = None):
        """`_acc_group` as torch ops on the plain field operations, `chunk`
        terms at a time: the x^s rows, the weighted terms and their tree
        sum as (chunk, N, 3) tensors."""
        N = length if length is not None else self.fri.domain.length
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
                              slots, uds: Optional[Sequence[int]] = None):
        """acc += the combination's quotient terms: each table's quotients
        (`Table.quotients`), then the permutation arguments' two difference
        quotients, each weighed by (w_plain + w_shift·x^s) as `_acc_group`
        weighs a group, in that order (the JAX package's comb_quot{ti} and
        comb_acc_q{T} for each table, then comb_pa and comb_acc_q2).
        zinvs: each table's zerofier inverses; w_pairs (T, 2, 3); ratios and
        starts (D,), the x^s progression of each distinct shift, and
        slots[t] term t's (`quotient_kernels.distinct_shifts`). `uds` takes
        the place of the tables' row shifts for the streamed, per-class
        evaluation, where a shift by unit_distance over the domain is a
        shift by unit_distance/B within each strided class. On a CUDA
        device one launch of kernel F4 (`quotient_kernels.
        quotient_combination`, after its prologue), which reads the columns
        where they lie and each next row at its shifted position (under a
        mesh, from the columns `mesh.roll` brought), updates acc in place
        and makes no (T, n, 3) stack; on the CPU
        `_quotient_combination_plain`."""
        operands = (acc, *base_cws, *ext_cws, challenges, terminals,
                    *(z for zinv in zinvs for z in zinv.values()), w_pairs,
                    ratios, starts)
        if fk.card_device(*operands) is None:
            return self._quotient_combination_plain(
                acc, base_cws, ext_cws, challenges, terminals, zinvs,
                w_pairs, ratios, starts, slots, uds)
        N = self.fri.domain.length
        n = int(acc.shape[0])
        sharded = uds is None and self.mesh is not None
        tables = []
        for ti, t in enumerate(self.tables):
            ud = t.unit_distance(N) if uds is None else uds[ti]
            base, ext = base_cws[ti], ext_cws[ti]
            if sharded and ud:
                tables.append((base, ext, zinvs[ti], 0,
                               self.mesh.roll(base, ud, 1, N),
                               self.mesh.roll(ext, ud, 1, N)))
            else:
                tables.append((base, ext, zinvs[ti], ud % n))
        progs = [self._quotient_program(ti) for ti in range(len(self.tables))]
        return qk.quotient_combination(acc, progs, tables, challenges,
                                       terminals, w_pairs, ratios, starts,
                                       slots)

    def _quotient_combination_plain(self, acc, base_cws, ext_cws,
                                    challenges, terminals, zinvs, w_pairs,
                                    ratios, starts, slots,
                                    uds: Optional[Sequence[int]] = None):
        """`_quotient_combination` op by op: each table's
        `_table_quotient_stack_plain`, then the permutation stack, each
        through `_acc_group_plain`. On CUDA tensors the stacks' field
        operations are F1/F2 launches (the form F4 replaced, kept as its
        yardstick)."""
        n = int(acc.shape[0])
        index = transfer(torch.tensor(slots), ratios.device)
        ratios, starts = ratios[index], starts[index]
        pos = 0
        for ti in range(len(self.tables)):
            stack = self._table_quotient_stack_plain(
                ti, base_cws[ti], ext_cws[ti], challenges, terminals,
                zinvs[ti], None if uds is None else uds[ti])
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

    def _quotient_program(self, ti):
        """Table ti's recorded quotient program (`quotient_kernels.program`),
        kept per table size: the IO tables' exponent is height - length."""
        t = self.tables[ti]
        cache = self.__dict__.setdefault("_quotient_programs", {})
        key = (ti, t.height, t.length)
        if key not in cache:
            if t.name != qk.TABLES[ti]:
                raise ValueError(f"table {ti} is {t.name}, F4 has "
                                 f"{qk.TABLES[ti]}")
            cache[key] = qk.program(t)
        return cache[key]

    def _table_quotient_stack_plain(self, ti, base_cw, ext_cw, challenges,
                                    terminals, zinv,
                                    ud: Optional[int] = None):
        """All quotient codewords of table ti as one (T, n, 3) stack, op by
        op: `Table.quotients` over `ArrayAlgebra`, the next row a rolled
        copy of the columns (under a mesh, rolled across the ranks by
        `mesh.roll`). `ud` takes the place of the row shift in a streamed
        class. On CPU tensors the plain field operations; on CUDA tensors
        every operation is its own F1/F2 launch."""
        t = self.tables[ti]
        alg = ArrayAlgebra(self.device)
        ch_vals = [alg.x(challenges[i]) for i in range(11)]
        tm_vals = [alg.x(terminals[i]) for i in range(5)]
        N = self.fri.domain.length
        sharded = ud is None and self.mesh is not None
        if ud is None:
            ud = t.unit_distance(N)

        def rot(arr):
            """Rows shifted by the unit distance along axis 1; over the
            whole domain under a mesh, where the shift may exceed a block
            and the rows come from other ranks."""
            if not ud:
                return arr
            if sharded:
                return self.mesh.roll(arr, ud, 1, N)
            return torch.roll(arr, -ud, 1)

        base_next, ext_next = rot(base_cw), rot(ext_cw)
        point = [alg.base(base_cw[j]) for j in range(t.base_width)]
        point += [alg.x(ext_cw[j]) for j in range(t.num_ext_columns)]
        point_next = [alg.base(base_next[j]) for j in range(t.base_width)]
        point_next += [alg.x(ext_next[j]) for j in range(t.num_ext_columns)]
        q = t.quotients(alg, point, point_next, ch_vals, tm_vals, zinv)
        return torch.stack(q, dim=0)

    # -- streamed (strided-class) prover pieces ----------------------------
    # At FRI domains >= config.stream_min whole base/ext codewords never
    # exist: coefficient groups are evaluated and committed in B strided
    # classes (protocol/stream.py). Transcript bytes equal the resident
    # path's (tests/test_torch_stream.py, tests/test_torch_stark.py).
    #
    # What the JAX package does here for its compiler and runtime, and the
    # port has no counterpart for: per-class data as runtime arguments of
    # once-compiled stages; a hard sync per block against the host running
    # ahead of the device (torch's caching allocator reuses freed blocks in
    # stream order, so a later class's temporaries take the earlier one's);
    # the STARK_STREAM_SYNC_ALL bisection aid; the flat randomizer draw and
    # its PRF_D chunking, and the quotients accumulated from a list instead
    # of a stack (all three against a padded tile layout: on an H100 the
    # list form held the stacked form's peak to the byte, PERF.md, so the
    # classes go through `_acc_group` as the resident path does).

    def _stream_plan(self):
        """B, S and the size-S transform's plan, built once per prover. A
        "group" key set on the cached plan fixes the classes a dispatch of
        the commit passes and the reopen (`stream.group_size_for`), as the
        JAX package's plan does."""
        cache = getattr(self, "_splan_cache", None)
        if cache is not None:
            return cache
        N = self.fri.domain.length
        # B must divide every table's unit distance N/height, so that the
        # transition's row shift stays within a class
        B = self.config.stream_classes
        for t in self.tables:
            if t.height > 0:
                B = min(B, t.unit_distance(N))
        B = max(B, 2)
        self._splan_cache = make_stream_plan(N, B, self.fri.domain.omega,
                                             self.device)
        return self._splan_cache

    def _claim_key(self) -> str:
        return proof_key(
            self.program, self.input_symbols, self.output_symbols, self.config
        )

    def _streamed_commit_cached(self, groups, salt_key: bytes, splan, tag):
        """`streamed_commit`, remembered per stage: with a seeded rng and a
        `checkpoint_dir`, the accumulated class-level digests are kept per
        (claim, stage); a resumed run derives the cheap deterministic state
        again (groups, rng draws) and skips the streaming hash pass, to the
        identical tree. Tags of stages loaded from a checkpoint are recorded
        in `last_commit_resumes`."""
        cfg = self.config
        if not cfg.checkpoint_dir or cfg.seed is None:
            return streamed_commit(groups, salt_key, splan)
        key = self._claim_key()
        got = load_commit_stage(cfg.checkpoint_dir, key, tag)
        if got is not None:
            self.last_commit_resumes.append(tag)
            top = transfer(torch.from_numpy(got), self.device)
            return StreamedSaltedMerkle(splan["N"], splan["B"], top, salt_key)
        tree = streamed_commit(groups, salt_key, splan)
        # levels[0] is the level-log2(B) digest array that the ladder builds
        # everything above from
        save_commit_stage(
            cfg.checkpoint_dir, key, tag, to_host(tree.levels[0]).numpy()
        )
        return tree

    def _stage_base_coeffs(self, mats, rand_coeffs, base_rands, packs):
        """Offset-prescaled coefficient groups of every base commitment row
        (randomizer limbs first, then each table's base columns): the
        streamed prover's persistent state, in the zip order of the resident
        base commitment."""
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

    def _stage_ext_coeffs(self, xcols, ext_rands, packs):
        """Extension-column coefficient groups (3 limb rows a column, in the
        zip order of the resident extension commitment)."""
        groups = []
        for i, (t, cols, r) in enumerate(zip(self.tables, xcols, ext_rands)):
            if t.height == 0:
                groups.append(
                    torch.zeros((3 * t.num_ext_columns, 1), dtype=torch.int64,
                                device=self.device)
                )
                continue
            tp = packs["tables"][i]
            trace = cols.movedim(0, -1)  # (n_ext, 3, H)
            trace = trace.reshape((-1, trace.shape[-1]))
            rr = None
            if r is not None:
                rr = r.movedim(-1, 1).reshape((-1, r.shape[1]))
            groups.append(
                nt.lde_coefficients_unpadded(trace, rr, tp[0], tp[1])
            )
        return tuple(groups)

    def _zinv_stream(self):
        """Zerofier-inverse state of a streamed prove: the boundary and the
        per-height terminal inverses at full length (natural order, gathered
        per class) and the small periodic inverse of x^H - 1; the transition
        inverse is recomposed per class, not stored at full length (2 of 3
        N-arrays a height saved). Dropped by `prove` after its last use."""
        cache = getattr(self, "_zs_cache", None)
        if cache is not None:
            return cache
        dev = self.device
        N = self.fri.domain.length
        omega = self.fri.domain.omega
        offset = self.fri.domain.offset

        def scalar(v):
            return u64_to_tensor([v], dev)

        one = f.const(1, torch.empty(0, device=dev))
        domain = f.geometric_rows(scalar(offset), scalar(omega), N)[0]
        out = {"boundary": f.batch_inverse(f.sub(domain, one)), "heights": {}}
        for t in self.tables:
            h = t.height
            if h in out["heights"]:
                continue
            if h == 0:
                out["heights"][h] = None
                continue
            o_inv = f.h_inverse(t.omicron)
            xs = f.geometric_rows(
                scalar(f.h_pow(offset, h)), scalar(f.h_pow(omega, h)), N // h
            )[0]
            out["heights"][h] = {
                "terminal": f.batch_inverse(f.sub(domain, scalar(o_inv))),
                "small": f.batch_inverse(f.sub(xs, one)),
                "o_inv": o_inv,
            }
        self._zs_cache = out
        return out

    def _stream_zinv_block(self, b: int, zs, splan):
        """Class b's zerofier inverses, {height: {boundary, transition,
        terminal}}: strided gathers from the stored boundary and terminal
        arrays, and the transition (x - o^-1)/(x^H - 1) recomposed from the
        periodic small table."""
        dev = self.device
        N, B, S = splan["N"], splan["B"], splan["S"]
        domain = self.fri.domain
        x_blk = f.geometric_rows(
            u64_to_tensor([f.h_mul(domain.offset, f.h_pow(domain.omega, b))],
                          dev),
            u64_to_tensor([f.h_pow(domain.omega, B)], dev), S,
        )[0]

        def cls(arr):
            return arr.reshape(-1, B)[:, b]

        boundary = cls(zs["boundary"])
        out = {}
        for h, d in zs["heights"].items():
            if d is None:
                zero = torch.zeros((S,), dtype=torch.int64, device=dev)
                out[h] = {"boundary": boundary, "transition": zero,
                          "terminal": zero}
                continue
            # the small table's period N/h is the unit distance, and B
            # divides it (`_stream_plan`)
            small_cls = cls(d["small"])  # (N/h/B,)
            transition = f.mul(
                small_cls.repeat(S // small_cls.shape[0]),
                f.sub(x_blk, u64_to_tensor([d["o_inv"]], dev)),
            )
            out[h] = {"boundary": boundary, "transition": transition,
                      "terminal": cls(d["terminal"])}
        return out

    def _stream_combination(self, base_groups, ext_groups, challenges_arr,
                            terminals_arr, weights_h, shifts, offset_pows,
                            splan):
        """Quotients and the nonlinear combination evaluated per strided
        class; returns the assembled (N, 3) combination codeword."""
        dev = self.device
        N, B, S = splan["N"], splan["B"], splan["S"]
        omega = splan["omega"]
        with span("zerofiers"):
            zs = self._zinv_stream()
        scale_len_b = max(int(g.shape[1]) for g in base_groups)
        scale_len_e = max(int(g.shape[1]) for g in ext_groups)
        w0 = u64_to_tensor(weights_h[0], dev)
        w_pairs = u64_to_tensor(weights_h[1:], dev).reshape(-1, 2, 3)
        wbs = f.powers(omega, B, dev)
        num_base = sum(t.base_width for t in self.tables)
        num_ext = sum(t.num_ext_columns for t in self.tables)
        # the base and extension terms each with its x^s progression, the
        # quotient terms with one a distinct shift (`terms`); per-term
        # ratios (ω^B)^s are the same for every class
        q0 = num_base + num_ext
        slots, distinct = qk.distinct_shifts(shifts[q0:])
        terms = list(range(q0)) + [q0 + slots.index(k)
                                   for k in range(len(distinct))]
        ratios = u64_to_tensor(
            [f.h_pow(omega, (B * int(shifts[j])) % N) for j in terms], dev
        )
        uds = [t.unit_distance(N) // B for t in self.tables]

        # leaf i = q·B + b  ->  comb[q, b] = class b's value at position q
        comb = torch.empty((S, B, 3), dtype=torch.int64, device=dev)
        for b in range(B):
            with span("class"):
                wb = wbs[b : b + 1]
                # per-term x^s starts on this class: (offset·ω^b)^s
                starts = u64_to_tensor(
                    [
                        f.h_mul(int(offset_pows[j]),
                                f.h_pow(omega, (b * int(shifts[j])) % N))
                        for j in terms
                    ],
                    dev,
                )
                base_vals = block_values(base_groups, wb, scale_len_b,
                                         splan["pack_S"], S)
                ext_vals = block_values(
                    ext_groups, wb, scale_len_e, splan["pack_S"], S
                ).reshape(num_ext, 3, S).movedim(1, -1)  # (num_ext, S, 3)
                zinv_b = self._stream_zinv_block(b, zs, splan)

                acc = xf.mul(w0[None, :].expand(S, 3),
                             base_vals[:3].movedim(0, -1))
                acc = self._acc_group(acc, base_vals[3:], w_pairs[:num_base],
                                      ratios[:num_base], starts[:num_base],
                                      length=S)
                acc = self._acc_group(acc, ext_vals, w_pairs[num_base:q0],
                                      ratios[num_base:q0], starts[num_base:q0],
                                      length=S)

                base_cws_b, ext_cws_b = [], []
                row0, ext0 = 3, 0
                for t in self.tables:
                    base_cws_b.append(base_vals[row0 : row0 + t.base_width])
                    ext_cws_b.append(ext_vals[ext0 : ext0 + t.num_ext_columns])
                    row0 += t.base_width
                    ext0 += t.num_ext_columns
                acc = self._quotient_combination(
                    acc, base_cws_b, ext_cws_b, challenges_arr, terminals_arr,
                    [zinv_b[t.height] for t in self.tables], w_pairs[q0:],
                    ratios[q0:], starts[q0:], slots, uds,
                )
                comb[:, b] = acc
                del base_vals, ext_vals, base_cws_b, ext_cws_b, zinv_b, acc
        return comb.reshape(N, 3)

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
        # quotient terms with one a distinct shift (`terms`); under a mesh
        # the rank's block: N points from index lo, whose x^s rows start at
        # (offset·ω^lo)^s with the unchanged ratio ω^s
        q0 = num_base + num_ext
        slots, distinct = qk.distinct_shifts(shifts[q0:])
        terms = list(range(q0)) + [q0 + slots.index(k)
                                   for k in range(len(distinct))]
        lo, N = self._block()
        ratios = u64_to_tensor([f.h_pow(omega, int(shifts[j])) for j in terms],
                               dev)
        opows = u64_to_tensor(
            [f.h_mul(int(offset_pows[j]), f.h_pow(omega, lo * int(shifts[j])))
             if lo else offset_pows[j] for j in terms],
            dev,
        )
        w0 = u64_to_tensor(weights_h[0], dev)
        w_pairs = u64_to_tensor(weights_h[1:], dev).reshape(-1, 2, 3)
        with span("zerofiers"):
            zinv = self._zerofier_inverses()

        acc = xf.mul(w0[None, :].expand(N, 3), rand_cw)
        # the base and extension groups as the LDE tensors' column views;
        # an empty table's extension columns (zeros) as a zero-stride view
        # of one zero word, which F3 and F4 read without touching N words
        ext_cws = [cw if t.height else cw.new_zeros(()).expand(cw.shape)
                   for t, cw in zip(self.tables, ext_cws)]
        acc = self._acc_group(acc, list(base_cws), w_pairs[:num_base],
                              ratios[:num_base], opows[:num_base], length=N)
        acc = self._acc_group(acc, ext_cws, w_pairs[num_base:q0],
                              ratios[num_base:q0], opows[num_base:q0],
                              length=N)
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
        with SpanRecorder(self.device, self.config.seed) as timer:
            return self._prove(
                timer, processor_matrix, memory_matrix, instruction_matrix,
                input_matrix, output_matrix, proof_stream)

    def _prove(self, timer, processor_matrix, memory_matrix,
               instruction_matrix, input_matrix, output_matrix, proof_stream):
        """`prove`'s body; `timer` is the prove's SpanRecorder, whose stages
        are the marks of `last_metrics["stages_s"]`."""
        cfg = self.config
        dev = self.device
        mesh = self.mesh
        seed = cfg.seed
        if mesh is not None:
            mesh.reset_stats()
            if seed is None:
                # the ranks agree only while every Fiat-Shamir input is the
                # same: an unseeded mesh prove runs on rank 0's fresh seed
                seed = int.from_bytes(
                    mesh.broadcast_bytes(os.urandom(16), 16), "little")
        rng = Rng(seed)
        fri = self.fri
        N = fri.domain.length
        use_stream = self.use_stream
        native = self.codec.name == "native"
        device_commit = self._device_commit()
        sharded_commit = self._sharded_commit()
        self.last_commit_resumes = []
        stage, begin, end = timer.stage, timer.begin, timer.end
        # the stages, in order: the commitments' label says where the tree
        # is built
        tree_at = (" (streamed)" if use_stream
                   else " (device)" if device_commit else "")
        comb_at = " (device)" if device_commit else ""

        def fri_stage():
            stage("fri.prove")
            # steps 15-16: the openings, up to FRI's own call
            begin("open")

        stage("stage_a (base coeffs)" if use_stream else "stage_a (base LDE)")
        # 1. populate and pad (ref brainfuck_stark.py:139-150)
        assert len(processor_matrix) + len(self.program) == len(instruction_matrix)
        matrices = [
            processor_matrix, instruction_matrix, memory_matrix,
            input_matrix, output_matrix,
        ]
        with span("pad"):
            for t, m in zip(self.tables, matrices):
                t.matrix = np.asarray(m, dtype=U64).reshape(-1, t.base_width)
                if len(t.matrix) > 0:
                    t.pad()

        if proof_stream is None:
            proof_stream = self.codec.make_stream()

        # 2-3. randomizer polynomial (BLAKE2b counter PRF, drawn where it is
        # consumed) + base LDE (ref :164-176)
        rand_count = (self.max_degree + 1) * 3
        with span("randomizer"):
            randomizer_coeffs = prf_field_words(
                salt_key_words(rng.bytes(16), dev), rand_count
            )
            base_rands_h = [
                rng.base_elements((t.base_width, t.num_randomizers))
                if t.num_randomizers > 0 and t.height > 0
                else None
                for t in self.tables
            ]
        with span("upload"):
            mats = tuple(u64_to_tensor(t.matrix, dev) for t in self.tables)
            base_rands = tuple(None if r is None else u64_to_tensor(r, dev)
                               for r in base_rands_h)
        with span("tables"):
            packs = self._lde_packs()
            splan = self._stream_plan() if use_stream else None
        with span("lde"):
            if use_stream:
                # streamed mode: only coefficient groups persist (see
                # protocol/stream.py); the transcript equals the resident one
                base_groups = self._stage_base_coeffs(
                    mats, randomizer_coeffs, base_rands, packs
                )
                del randomizer_coeffs
            else:
                randomizer_codeword, base_codewords = self._stage_base_lde(
                    mats, randomizer_coeffs, base_rands, packs
                )

        stage("base merkle" + tree_at)
        # 4. salted commitment to the zipped base codewords (ref :178-180)
        base_salt_key = rng.bytes(16)
        num_base_cols = sum(t.base_width for t in self.tables)
        base_widths = [3] + [1] * num_base_cols
        if use_stream:
            base_tree = self._streamed_commit_cached(
                base_groups, base_salt_key, splan, "base"
            )
            base_row = base_tree.row_at
        else:
            zipped_base = torch.cat(
                [randomizer_codeword] + [cw.T for cw in base_codewords], dim=1
            )  # (N, 3 + num_base_columns)
            base_tree, base_row = self._salted_commit(
                zipped_base, salt_key_words(base_salt_key, dev), base_widths
            )
        stage("extend (device scan)")
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
        with span("scan"):
            challenges_arr = u64_to_tensor(challenges_h, dev)
            initials_arr = u64_to_tensor(initials_h, dev)
            xcols, terms_dev = self._device_extend(mats, challenges_arr,
                                                   initials_arr)
        with span("terminals"):
            for t, terms in zip(self.tables, terms_dev):
                terms = tensor_to_u64(terms)
                t.terminals = {
                    n: tuple(int(v) for v in terms[j])
                    for j, n in enumerate(t.terminal_names)
                }
        stage("stage_b (ext coeffs)" if use_stream else "stage_b (ext LDE)")
        terminals_h = self._terminals_list()

        # 8. extension LDE (ref :194-199)
        if use_stream:
            ext_groups = self._stage_ext_coeffs(xcols, ext_rands, packs)
            # the trace matrices and the extension columns were consumed by
            # stage_a, the scan and stage_b: only the groups persist
            del xcols, mats
        else:
            ext_codewords = self._stage_ext_lde(xcols, ext_rands, packs)
            del xcols

        stage("ext merkle" + tree_at)
        ext_salt_key = rng.bytes(16)
        num_ext_cols = sum(t.num_ext_columns for t in self.tables)
        ext_widths = [3] * num_ext_cols
        if use_stream:
            ext_tree = self._streamed_commit_cached(
                ext_groups, ext_salt_key, splan, "ext"
            )
            ext_row = ext_tree.row_at
        else:
            zipped_ext = torch.cat(
                [cw.movedim(0, 1).reshape(cw.shape[1], -1)
                 for cw in ext_codewords],
                dim=1,
            )  # (N, 3 * num_ext_columns)
            ext_tree, ext_row = self._salted_commit(
                zipped_ext, salt_key_words(ext_salt_key, dev), ext_widths
            )
        stage("stage_c (quotients+combination)")
        ext_leaf_cache: Dict[int, tuple] = {}

        def ext_leaf_obj(idx):
            if idx not in ext_leaf_cache:
                ext_leaf_cache[idx] = _row_to_leaf_object(
                    ext_row(idx), ext_widths
                )
            return ext_leaf_cache[idx]

        proof_stream.push(ext_tree.root())

        if cfg.debug_degree_checks and not use_stream:
            # (a streamed prove never holds the whole codewords that the
            # check interpolates; run DEBUG at resident sizes)
            self.debug_check_degrees(
                base_codewords, ext_codewords, challenges_h, terminals_h
            )

        begin("symbolic")
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
        end()

        # 12. quotients + nonlinear combination (ref :204-218, :240-298)
        begin("combination")
        all_shift_bounds = (
            self._base_degree_bounds() + self._ext_degree_bounds()
            + quotient_degree_bounds
        )
        shifts = [self.max_degree - b for b in all_shift_bounds]
        offset_pows = [f.h_pow(fri.domain.offset, s) for s in shifts]
        terminals_arr = u64_to_tensor(terminals_h, dev)
        if use_stream:
            combination = self._stream_combination(
                base_groups, ext_groups, challenges_arr, terminals_arr,
                weights_h, shifts, offset_pows, splan,
            )
        else:
            combination = self._combination_pipeline(
                randomizer_codeword, base_codewords, ext_codewords,
                challenges_arr, terminals_arr, weights_h, shifts, offset_pows,
            )
        end()

        stage("combination merkle" + comb_at)
        # 13. commit to the combination codeword (ref :301-302)
        if mesh is not None and not sharded_commit:
            combination = mesh.all_gather(combination)
        if device_commit:
            combination_tree = DeviceMerkle(
                combination, cut=default_cut(N),
                mesh=mesh if sharded_commit else None,
            )
            comb_row = combination_tree.row_at
        else:
            combination = to_host(combination)
            comb_host = tensor_to_u64(combination)
            if native:
                combination_tree = Merkle.from_buffer(
                    comb_host.astype("<u8").tobytes(), 24, N
                )
            else:
                combination_tree = Merkle([
                    self.codec.leaf_payload(tuple(int(v) for v in row))
                    for row in comb_host
                ])
            comb_row = lambda idx: comb_host[idx]  # noqa: E731
        if use_stream:
            stage("reopen (streamed 2nd pass)")
        else:
            fri_stage()
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
        if device_commit or use_stream:
            open_idx = sorted(
                {
                    (index + d) % N
                    for index in indices
                    for d in [0] + unit_distances
                }
            )
            if use_stream:
                # second streaming pass: evaluate the classes again, gather
                # the opened positions and hash their runs on the device
                with span("base"):
                    base_tree.resolve(open_idx,
                                      reopen_rows(base_groups, splan))
                with span("ext"):
                    ext_tree.resolve(open_idx, reopen_rows(ext_groups, splan))
                # the groups and the zerofier-inverse store had their last
                # use above: free them before FRI runs
                del base_groups, ext_groups
                self._zs_cache = None
                fri_stage()
            batch = [(base_tree, open_idx), (ext_tree, open_idx)]
            if device_commit:
                batch.append((combination_tree, indices))
            with span("prefetch"):
                prefetch_trees(batch)
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
        end()

        # 17. FRI (ref :336). Under the reference codec round 0 opens the
        # very leaf objects that step 16 pushed (pickle memo references) and
        # builds its tree again from them
        with span("fri"):
            self.fri.prove(
                combination, proof_stream, on_device=device_commit,
                tree0=combination_tree if native else None,
                sharded=sharded_commit,
                leaf_objs0=(None if native
                            else [comb_leaf_obj(i) for i in range(N)]),
            )
        stage("serialize")
        proof = proof_stream.serialize()
        timer.finish()
        T = self.tables[0].height

        def per_s(count, *substrings):
            """count over the summed time of the stages whose labels hold
            any of `substrings`; None when that time is 0."""
            s = sum(v for k, v in timer.stages.items()
                    if any(x in k for x in substrings))
            return round(count / s) if s > 0 else None

        # NTT butterflies: every coefficient row through the two forward
        # N-NTTs plus each table's height-H INTTs, whatever ran them
        logN = N.bit_length() - 1
        butterflies = (3 + num_base_cols + 3 * num_ext_cols) * (N // 2) * logN
        for t in self.tables:
            if t.height > 1:
                h = t.height
                butterflies += ((t.base_width + 3 * t.num_ext_columns)
                                * (h // 2) * (h.bit_length() - 1))
        # BLAKE2b leaves: base + ext + combination trees at N, plus every
        # FRI fold round's tree (round 0 reuses the combination tree)
        hash_leaves = 3 * N + sum(
            N >> r for r in range(1, self.fri.num_rounds())
        )
        totals = timer.record.totals()
        self.last_metrics = timer.report(
            fri_domain=N,
            trace_height=T,
            cycles_per_s=round(T / timer.total(), 2),
            proof_bytes=len(proof),
            ntt_butterflies=butterflies,
            ntt_butterflies_per_s=per_s(butterflies, "stage_a", "stage_b"),
            hash_leaves=hash_leaves,
            hash_leaves_per_s=per_s(hash_leaves, "merkle", "fri.prove"),
            extend_rows_per_s=per_s(
                sum(t.height for t in self.tables), "extend"),
            fri_round_s=[round(s.seconds, 4) for s in timer.record.spans
                         if s.name == "round"],
            device=str(dev),
            mesh=(None if mesh is None
                  else {**mesh.describe(), **mesh.stats_report(),
                        "sharded_commit": sharded_commit}),
            ntt_path=self._mesh_ntt_path(),
            stream_classes=splan["B"] if use_stream else None,
            stream_block=splan["S"] if use_stream else None,
            # classes a dispatch of the two commit passes and the reopen
            stream_group=(group_size_for(splan["B"], splan["S"],
                                         splan.get("group"))
                          if use_stream else None),
            # the engine of the trees at N (base, extension, combination);
            # FRI's smaller trees may take another: hashlib below
            # NATIVE_MIN_LEAVES, host trees below fri_host_min
            hash_path=(
                ("cuda-blake2b" if dev.type == "cuda" else "torch-plain")
                if device_commit or use_stream
                else "host-cpp" if native and N >= NATIVE_MIN_LEAVES
                else "host-hashlib"
            ),
            **{key: totals.get(counter, 0) for key, counter in (
                ("blake2b_launches", "b1"), ("subntt_launches", "b2"),
                ("twiddle_outer_launches", "b3"),
                ("gl_elementwise_launches", "f1"),
                ("xf_elementwise_launches", "f2"),
                ("acc_group_launches", "f3"), ("quotient_launches", "f4"),
                # the 2^cut-leaf runs that openings hashed on the device
                ("open_runs", "open_runs"))},
        )
        return proof

    def _salted_commit(self, zipped, key, widths: List[int]):
        """Salted Merkle commitment to the rows of `zipped` (N, k): a device
        tree from `device_commit_min` up under the native codec, else a host
        hashlib tree (under the reference codec over the pickled leaf object
        of each row, whose columns are `widths` words wide). Under a mesh
        `zipped` is the rank's block: the tree is built in blocks, with the
        salts of the rank's own leaf indices, while a block keeps enough
        leaves; else the rows are gathered first. The salts come from the
        salt PRF on the device either way. Returns (tree, row accessor)."""
        mesh = self.mesh
        N = self.fri.domain.length
        if self._sharded_commit():
            lo, n = self._block()
            salts = salt_words_device(
                key, n, indices=torch.arange(lo, lo + n, dtype=torch.int64,
                                             device=zipped.device))
            tree = DeviceSaltedMerkle(zipped, salts, cut=default_cut(N),
                                      mesh=mesh)
            return tree, tree.row_at
        if mesh is not None:
            zipped = mesh.all_gather(zipped)
        salts = salt_words_device(key, N)
        if self._device_commit():
            tree = DeviceSaltedMerkle(zipped, salts, cut=default_cut(N))
            return tree, tree.row_at
        rows = tensor_to_u64(zipped)
        salt_buf = SaltBuffer(salt_words_to_buffer(salts))
        if self.codec.name == "native":
            buf, plen = _salted_payload_buffer(rows, salt_buf.buf)
            tree = SaltedMerkle.from_buffer(buf, plen, N, salt_buf)
        else:
            # fresh leaf objects: the opened ones come from the prover's
            # leaf cache, as in the JAX package
            tree = SaltedMerkle(
                [self.codec.salted_payload(_row_to_leaf_object(rows[i], widths),
                                           salt_buf[i])
                 for i in range(N)],
                salt_buf,
            )
        return tree, (lambda idx: rows[idx])

    # ------------------------------------------------------------------
    # verifier
    # ------------------------------------------------------------------

    def verify(self, proof: bytes) -> bool:
        """Verify a proof (from either package); the arithmetic runs on CPU
        tensors, one lane per query index."""
        self.last_rejection = None
        cfg = self.config
        fri = self.fri
        N = fri.domain.length
        proof_stream = self.codec.load_stream(proof)

        base_root = proof_stream.pull()
        challenges_h = sample_weights(11, proof_stream.verifier_fiat_shamir())
        ext_root = proof_stream.pull()

        terminals_h = [tuple(proof_stream.pull()) for _ in range(5)]

        base_degree_bounds = self._base_degree_bounds()
        ext_degree_bounds = self._ext_degree_bounds()

        num_base = sum(t.base_width for t in self.tables)
        num_ext = sum(t.num_ext_columns for t in self.tables)
        num_quot = sum(
            t.num_quotients(challenges_h, terminals_h) for t in self.tables
        )
        num_diff = len(self.permutation_arguments)

        weights_h = sample_weights(
            1 + 2 * num_base + 2 * num_ext + 2 * num_quot + 2 * num_diff,
            proof_stream.verifier_fiat_shamir(),
        )

        combination_root = proof_stream.pull()

        indices = sample_indices_stark(
            cfg.security_level, proof_stream.verifier_fiat_shamir(), N
        )
        unit_distances = list(set([t.unit_distance(N) for t in self.tables]))

        # -- pull & check salted openings (ref :421-440) --------------------
        tuples: Dict[int, list] = {}
        for index in indices:
            for distance in [0] + unit_distances:
                idx = (index + distance) % N
                element = proof_stream.pull()
                salt, path = proof_stream.pull()
                if not SaltedMerkle.verify(
                    base_root, idx, path,
                    self.codec.salted_payload(element, salt),
                ):
                    return reject(
                        self,
                        f"base codeword opening at index {idx} fails its "
                        f"salted-Merkle path",
                    )
                row = [tuple(element[0])] + [int(e) for e in element[1:]]
                tuples[idx] = row

                element = proof_stream.pull()
                salt, path = proof_stream.pull()
                if not SaltedMerkle.verify(
                    ext_root, idx, path,
                    self.codec.salted_payload(element, salt),
                ):
                    return reject(
                        self,
                        f"extension codeword opening at index {idx} fails "
                        f"its salted-Merkle path",
                    )
                tuples[idx] = tuples[idx] + [tuple(e) for e in element]

        # -- recompute the combination, vectorised over all indices ---------
        K = len(indices)
        alg = ArrayAlgebra("cpu")
        ch_vals = [alg.x(u64_to_tensor(c)) for c in challenges_h]
        tm_vals = [alg.x(u64_to_tensor(t_)) for t_ in terminals_h]
        xs = u64_to_tensor([fri.domain(i) for i in indices])  # (K,)
        one = u64_to_tensor([1])
        ext_offset = 1 + num_base

        def col_base(col, idx_list):
            return u64_to_tensor([tuples[i][1 + col] for i in idx_list])

        def col_ext(col, idx_list):
            return u64_to_tensor([tuples[i][ext_offset + col] for i in idx_list])

        widx = 0
        inner = torch.zeros((K, 3), dtype=torch.int64)

        def add_term(arr):
            """arr: (K,) base or (K, 3) extension."""
            nonlocal widx, inner
            wb = u64_to_tensor(weights_h[widx])[None, :].expand(K, 3)
            widx += 1
            if arr.dim() == 1:
                inner = xf.add(inner, xf.mul_base(wb, arr))
            else:
                inner = xf.add(inner, xf.mul(wb, arr))

        def shifted(arr, bound):
            ps = f.pow_const(xs, self.max_degree - bound)
            if arr.dim() == 1:
                return f.mul(arr, ps)
            return xf.mul_base(arr, ps)

        add_term(u64_to_tensor([tuples[i][0] for i in indices]))
        for i in range(num_base):
            v = col_base(i, indices)
            add_term(v)
            add_term(shifted(v, base_degree_bounds[i]))
        for i in range(num_ext):
            v = col_ext(i, indices)
            add_term(v)
            add_term(shifted(v, ext_degree_bounds[i]))

        inv_xm1 = f.inverse(f.sub(xs, one))
        acc_base = 0
        acc_ext = 0
        points = []
        for t in self.tables:
            ud = t.unit_distance(N)
            nidx = [(i + ud) % N for i in indices]
            point = [alg.base(col_base(acc_base + j, indices)) for j in range(t.base_width)]
            point += [alg.x(col_ext(acc_ext + j, indices)) for j in range(t.num_ext_columns)]
            point_next = [alg.base(col_base(acc_base + j, nidx)) for j in range(t.base_width)]
            point_next += [alg.x(col_ext(acc_ext + j, nidx)) for j in range(t.num_ext_columns)]
            points.append(point)
            acc_base += t.base_width
            acc_ext += t.num_ext_columns

            o_inv = f.h_inverse(t.omicron) if t.height > 0 else 1
            x_minus_oinv = f.sub(xs, u64_to_tensor([o_inv]))
            if t.height > 0:
                transition_zinv = f.mul(
                    x_minus_oinv,
                    f.inverse(f.sub(f.pow_const(xs, t.height), one)),
                )
            else:
                transition_zinv = torch.zeros((K,), dtype=torch.int64)
            zinv = {
                "boundary": inv_xm1,
                "transition": transition_zinv,
                "terminal": f.inverse(x_minus_oinv),
            }
            quotients = t.quotients(
                alg, point, point_next, ch_vals, tm_vals, zinv
            )
            bounds = t.all_quotient_degree_bounds(challenges_h, terminals_h)
            for q, bound in zip(quotients, bounds):
                add_term(q)
                add_term(shifted(q, bound))

        # permutation-argument difference quotients (ref :540-547)
        col_in_point = {(0, 7): 7, (0, 8): 8, (1, 3): 3, (2, 4): 4}
        for pa in self.permutation_arguments:
            lhs = points[pa.lhs[0]][col_in_point[pa.lhs]].arr
            rhs = points[pa.rhs[0]][col_in_point[pa.rhs]].arr
            q = xf.mul_base(xf.sub(lhs, rhs), inv_xm1)
            add_term(q)
            add_term(shifted(q, pa.quotient_degree_bound()))

        assert widx == len(weights_h), (
            f"term count {widx} != weight count {len(weights_h)}"
        )

        inner_h = tensor_to_u64(inner)
        for k, index in enumerate(indices):
            combination_leaf = proof_stream.pull()
            combination_path = proof_stream.pull()
            if not Merkle.verify(
                combination_root, index, combination_path,
                self.codec.leaf_payload(combination_leaf),
            ):
                return reject(
                    self,
                    f"combination codeword opening at index {index} fails "
                    f"its Merkle path",
                )
            if tuple(combination_leaf) != tuple(int(v) for v in inner_h[k]):
                return reject(
                    self,
                    f"combination leaf at index {index} does not equal the "
                    f"recomputed weighted sum of trace/quotient terms",
                )

        # -- FRI (ref :572) --------------------------------------------------
        if not self.fri.verify(proof_stream, combination_root):
            return reject(
                self, f"FRI low-degree test failed: {self.fri.last_rejection}"
            )

        # -- evaluation arguments against public data (ref :575-577) --------
        if terminals_h[2] != evaluation_terminal(
            [ord(c) for c in self.input_symbols], challenges_h[8]
        ):
            return reject(
                self,
                "input evaluation terminal does not match the public input",
            )
        if terminals_h[3] != evaluation_terminal(
            [ord(c) for c in self.output_symbols], challenges_h[9]
        ):
            return reject(
                self,
                "output evaluation terminal does not match the public output",
            )
        if terminals_h[4] != program_evaluation_terminal(
            self.program,
            challenges_h[0], challenges_h[1], challenges_h[2], challenges_h[10],
        ):
            return reject(
                self,
                "program evaluation terminal does not match the public "
                "program",
            )

        return True


# ---------------------------------------------------------------------------


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
