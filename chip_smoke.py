"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR] [--b2-sweep] [--b2-parts]
                          [--stream-log2-cycles K] [--field-kernels]
                          [--ref-codec] [--mesh [RANKS]]

Drives `stark_brainfuck_tpu_torch` on the card, phase by phase, one JSON
line each; any failure raises and exits non-zero:

  1. device: `nvidia-smi` name and power limit, torch's device name;
  2. build: compiles every kernel source (csrc/*.cu) with nvcc, one
     process each, all started together, and the host runtime's C++
     sources (native/*.cpp, F4's host harness among them) with g++; native_host: the C++ trace recorder
     and the python one on the 2^16-cycle counter, arrays equal and the C++
     one at least 10x faster, the C++ one alone on the 2^20-cycle counter,
     and host Merkle trees of 2^14 and 2^16 leaves of 104 bytes from the
     C++ engine against hashlib, with the host's CPU count beside the times,
     then the engine built at six level widths from which a level hashes
     on every core, each timed on trees of 2^10 to 2^16 leaves;
  3. B1 checks: the BLAKE2b kernel against its plain torch version and
     `hashlib` at the prover's shapes, with CUDA-event times;
  4. B2 at every size m = 2 .. 2^13, forward and inverse, contiguous and
     strided with a ragged last tile, against its plain version, exactly;
     then B2 / B3 checks: the sub-NTT and outer-twiddle kernels against their
     plain torch versions, exactly, at the full-size prove's four-step
     shapes (FRI 2^21: c = 1024, r = 2048; 19 base and 27 extension rows):
     B2 in the two strided forms that `ntt_kernel` launches (the column
     pass, and the row pass with its transposed store) and in the
     contiguous `subntt` form; then ntt_full: the composed `ntt_kernel`
     against the u64 network at (19, 2^21) and (27, 2^21), with both times
     and the transform's own bound (two passes over the block of rows);
     field_kernels: the field layer's kernels (csrc/field.cu) against their
     plain torch versions, exactly, each launched once and counted: F1
     (add, sub, mul) on two 2^21-word codewords, at the u64 network's
     twiddle broadcast and on every pair of edge words; F2 (F_p^3 mul,
     mul_base) on (2^21, 3) codewords, contiguous and in the extension
     LDE's strided column layout, and on every pair of edge elements; F3
     (`_acc_group`) on all eight groups of the prove (base 16 terms,
     extension 9, each table's quotients, the 2 permutation quotients) as
     the resident prove hands them over at N = 2^21 (the LDE's column
     views, no concatenation) and as a streamed class does at S = 2^17 and
     S = 2^21, at ragged n (2^17 + 37, 1,000), with one term, and on a
     group of edge weights, ratios and starts; each also at every term
     split, with the card's launch plan (blocks an SM holds, registers),
     which must equal `field_kernels.acc_geometry`; quotient_kernel: F4
     (csrc/quotients.cu, each table's quotients in one launch) against
     the op-by-op stack `_table_quotient_stack_plain`, exactly, for all
     five tables, on the 2^15-cycle counter's own LDE columns, challenges,
     terminals and zerofier inverses (recorded from one prove): resident
     at N = 2^21, as a streamed class (class 1 of 16, S = 2^17, row shift
     ud / 16) and with the next row as columns rolled by the caller (rot
     0), each launched once and counted, timed beside the plain stack and
     bounded by `quotient_work`;
  5. bytes across devices: a seeded N=16384 prove on cuda and on cpu must
     give the same bytes, and both must verify; the same again with
     `ntt_backend="mxu"` (kernels B2/B3), whose bytes must equal the
     default backend's;
  6. full-size prove: a counter program of 2^15 cycles (FRI domain 2^21,
     the largest resident one) on the default NTT path (full_prove) and
     with `ntt_backend="mxu"` (full_prove_mxu): a warm-up prove and verify
     each, then two timed proves each, in turns, every one with its kernel
     launch counts (B1, B2, B3 and F1-F4; F1-F3 above 0 and F4 exactly 5
     a quotient evaluation on every prove of the card: one resident, one a
     class streamed), stage times, peak device memory at each stage mark and
     the prover's NTT butterfly, hashed leaf and extended row counts and
     rates (so too each stream_prove below); all proofs byte-identical;
     and in the same turns the default path with the quotient stacks op by
     op on F1/F2 (full_prove_plain_quotients, F4's baseline: no F4, and
     exactly the F1/F2 launches of `quotient_dispatches` more);
  7. the streamed prover (FRI domains >= `stream_min`, strided classes):
     stream_bytes: the N=16384 program with `stream_min=1,
     stream_classes=4` on cuda and on cpu, on both NTT paths, every proof
     equal to the resident one of step 5; stream_checkpoint: the same with
     a `checkpoint_dir`, whose second prove resumes both commit stages to
     the same bytes; stream_kernels: B1 against its plain version at the
     streamed shapes (32 classes of S = 2^17, G = 8 classes a dispatch: a
     group's G·S messages at both leaf widths and of its salt PRF, an
     in-group pair level of (G/2)·S pairs read from the group's digest
     block, an accumulator combine at S; the ladder's levels of 2^16 and
     1,024 parents; a 2-class group's 2^22 leaves; the 2^22 leaves and pair
     messages of the combination's tree), B2 and B3 against their plain
     versions in the launches of the size-S class transform at a group's
     batch (c = 256, r = 512; G x 19 and G x 27 rows), `block_values` on
     B2/B3 against the u64 network at (19, S) and (27, S), and
     `group_values` of G classes on B2/B3 and on the u64 network against G
     one-class evaluations, all exactly; stream_prove: a counter of 2^16
     cycles (FRI 2^22, which the default `stream_min` sends down the
     streamed path) proved resident (`stream_min` = 2^23) and streamed with
     32 (G = 8) and with 2 classes (G = 2), each on both NTT paths, all
     bytes equal, B2/B3 launched twice and once a class transform on the
     mxu path (4B/G + 2B transforms), B1 exactly as often as the resident
     prove's count gives (`streamed_b1`), with launch counts, the group,
     the merkle and reopen times, stage times and peak memory per prove
     beside the ungrouped prove's (`BASELINE_STREAM`), then the 32-class
     default prove again with the quotient stacks op by op (F4's
     baseline, as in step 6);
  8. the other paths of the main path's kernels: ref_codec_bytes: the
     N=16384 program with `codec="ref"` (host trees over pickled leaf
     objects; B1 still runs the salt and randomizer PRFs), the same bytes on
     cuda on both NTT paths and on cpu, verified, B1 launched (and B2/B3
     under mxu), not the native bytes; ref_codec_golden: a stark on the
     card accepts the reference prover's proof tests/vectors/
     ref_proof_plus4.bin and rejects it with a terminal changed;
     ref_codec_prove: a counter of about 2^10 cycles (FRI 2^16) under the
     reference codec, one timed prove and verify with its stage times;
     debug_degrees: the N=16384 program with `debug_degree_checks=True`,
     bytes equal to step 5's; poly_toolbox: `ops/fastpoly.py` on cuda equal
     to cpu and to `ops/poly.py` (interpolate, evaluate, coset division);
     soundness_params: security level 128 at
     expansion 16 (32 colinearity checks, the most its FRI allows), a
     FRI-2^14 program equal on cuda and cpu on both NTT paths, then a
     counter of 2^13 cycles (FRI 2^21, resident), one timed prove on each
     NTT path, same bytes, verified;
  9. the sharded prover (`mesh_shape`): the ranks of a mesh are worker
     processes of `parallel/multihost.py` that share the one card (gloo,
     exchanges staged through pinned host memory), the kernels built once
     here before they start. dntt_check: `distributed_ntt` over 2 and 4
     ranks at (27, 2^21) on both local routes, every rank's block equal to
     the single-device u64 network's, exactly, with each rank's B2/B3
     launches and the time of the torch copies left around them;
     mesh_kernels: on each of 2 ranks, B2 in the two strided forms of the
     distributed transform's local DFTs (19 and 27 rows), B3 with the rank's
     offset tables, B1 at the block's leaf, salt and tree-level sizes, and
     F4 on the block with the next row rolled across the ranks, each
     against its plain version, exactly; mesh_bytes: the N=16384
     program with `mesh_shape` 2 and 4, on cuda and on cpu, default and mxu, every rank's proof equal to step
     5's single-device proof, one verified; mesh_prove: the 2^15-cycle
     counter (FRI 2^21) on 2 ranks, default and mxu, a warm-up and a timed
     prove each, bytes equal to step 6's, and per rank the stage times, the
     bytes and seconds spent in collectives, peak device memory and
     B1/B2/B3 launches (every rank must launch B1, and B2 and B3 under
     mxu). A worker that fails makes the script exit non-zero;
  10. the card's name and power limit, then the kernels line;
  11. last line: {"ok": true, "device": {...}}.

`--field-kernels` runs only the field_kernels and quotient_kernel phases
after the build.
`--ref-codec` runs step 5 and then only step 8, and stops before the
kernels line. `--mesh [RANKS]` leaves out the kernel checks of steps 3 and
4 and all of steps 7 and 8, runs mesh_prove on RANKS ranks (2 by default) and stops before the
kernels line. On a machine with a card for every rank the ranks take
one each and the mesh runs on nccl. `--b2-sweep` and `--b2-parts` are
measuring aids for kernel B2: after the
build they time it under several tile shapes, or with its arithmetic or
its memory traffic cut out of the source, print one JSON line each and
stop before the checks. `--stream-log2-cycles K` is the same kind of aid
for the streamed prover: after the build it proves a counter of 2^K cycles
(FRI 2^(K+6)) with 32 classes on both NTT paths, holds the two proofs equal
and verified and the B2/B3 launches to the class transforms, prints one
stream_prove line each and stops.

Every bound is the larger of the bytes over HBM bandwidth and each
integer pipe's fewest instructions over its issue rate (`bound`, `Ops`).

Needs one CUDA card; without one it exits non-zero and prints no result.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 bandwidth,
# and the issue rate of one 32-bit integer pipe = 132 SMs x 64 lanes x 1.98
# GHz boost. On sm_90 the integer ALU pipe (the IADD3, LOP3/SHF and
# ISETP/SEL families of `sass_counts`) issues 64 lanes a clock per SM, and
# the IMAD families (the wide multiplies, IMAD.WIDE and IMAD.HI) issue 64
# more on the FMA pipe: a kernel's operations take at least the larger of
# the two pipes' counts over this rate (`bound`). Counting every 32-bit
# instruction at 128 lanes would halve the time of an ALU-only kernel such
# as B1, and is no lower bound.
HBM_BYTES_PER_S = 3.35e12
PIPE_OPS_PER_S = 132 * 64 * 1.98e9


class Ops:
    """Fewest 32-bit integer instructions of some work, by the pipe that
    issues them: `alu` (adds, logic, shifts, compares, selects) and `fma`
    (the IMAD-family wide multiplies). Adds and scales like a number."""

    __slots__ = ("alu", "fma")

    def __init__(self, alu=0, fma=0):
        self.alu, self.fma = alu, fma

    def __add__(self, other):
        if isinstance(other, int) and other == 0:  # sum() starts from 0
            return self
        return Ops(self.alu + other.alu, self.fma + other.fma)

    __radd__ = __add__

    def __mul__(self, k):
        return Ops(self.alu * k, self.fma * k)

    __rmul__ = __mul__

    def as_dict(self):
        return {"alu": self.alu, "fma": self.fma}


# fewest 32-bit integer instructions per BLAKE2b compression: 96
# G-functions of 4 three-input 64-bit adds (2 IADD3 each), 4 xors (2 LOP3
# each) and 3 funnel rotates (2 SHF each; the rotate by 32 is a free half
# swap), plus the 8-word feed-forward h ^= v ^ v' (2 LOP3 each): all ALU
OPS_PER_COMPRESSION = Ops(96 * (4 * 2 + 4 * 2 + 3 * 2) + 8 * 2)
# fewest 32-bit integer instructions per Goldilocks operation of
# csrc/goldilocks.cuh: a multiply is the 128-bit product (4 wide 32x32
# partial products on the FMA pipe, 4 carry adds) and its reduction
# (subtract hh with borrow 2, hl*(2^32-1) as shift-subtract 2, add with
# carry 2, two conditional corrections 2 each) = 14 ALU + 4 FMA; an add is
# a 64-bit add 2, its wrap correction 2 and the compare-subtract of p 2 =
# 6; a sub is 2 + 2 = 4 (a negation is a sub). A multiply by a power of
# two needs no wide product (it is a shift), so only its reduction counts,
# 10; a multiply by 1 counts nothing
GL_MUL_OPS = Ops(14, 4)
GL_POW2_MUL_OPS = Ops(10)
GL_ADD_OPS = Ops(6)
GL_SUB_OPS = Ops(4)

# trace cycles of the full-size prove, and the message count of the B1
# checks: the FRI domain is 64x the padded trace, 2^21
LOG2_CYCLES = 15
HASH_N = 1 << 21
LOG2_FRI = 21
# rows of the full-size prove's two forward LDE NTTs: 3 randomizer + 16
# base columns, and 3 x 9 extension columns
NTT_ROWS = {"base": 19, "ext": 27}

# the streamed prove: 2^16 cycles, FRI 2^22 = the default stream_min, in the
# default 32 classes (S = 2^17) and in 2 (S = 2^21)
STREAM_LOG2_CYCLES = 16
STREAM_CLASSES = (32, 2)
STREAM_S = (1 << (STREAM_LOG2_CYCLES + 6)) // STREAM_CLASSES[0]

# native_host: counters recorded by the C++ recorder (the first also by the
# python one), and host trees of 104-byte leaves; the tree engine is also
# built at each of NATIVE_PARALLEL_MINS (the level width from which a level
# hashes on every core; 2^40: never) and timed on NATIVE_SWEEP_LEAVES
NATIVE_LOG2_CYCLES = (16, 20)
NATIVE_TREE_LEAVES = (1 << 14, 1 << 16)
NATIVE_TREE_PLEN = 104
NATIVE_PARALLEL_MINS = (1, 256, 1024, 2048, 8192, 1 << 40)
NATIVE_SWEEP_LEAVES = (1 << 10, 1 << 12, 1 << 14, 1 << 16)
NATIVE_SWEEP_REPS = 5

# (n, W words, msg_len bytes) of the prover's BLAKE2b calls at FRI 2^21:
# Merkle parents, salt/randomizer PRF, base leaf (19+3 words), ext leaf
# (27+3 words), and a ragged multi-block case
B1_SHAPES = [
    (HASH_N, 16, 128),
    (HASH_N, 16, 24),
    (HASH_N, 32, 176),
    (HASH_N, 32, 240),
    (1000, 48, 337),
]


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


# SASS opcode families: the 64-bit multiply's IMAD forms, the integer adds,
# logic and shifts, moves, loads and stores; the rest is "other"
SASS_FAMILIES = (("IMAD.WIDE", ("IMAD.WIDE",)), ("IMAD.HI", ("IMAD.HI",)),
                 ("IMAD.MOV", ("IMAD.MOV",)), ("IMAD", ("IMAD",)),
                 ("IADD3", ("IADD3",)), ("LOP3/SHF", ("LOP3", "SHF")),
                 ("ISETP/SEL", ("ISETP", "SEL")), ("MOV", ("MOV",)),
                 ("loads", ("LDG", "LDS", "LDC", "LD", "ULDC")),
                 ("stores", ("STG", "STS", "ST")))


def sass_family(opcode: str) -> str:
    for family, prefixes in SASS_FAMILIES:
        if any(opcode == p or opcode.startswith(p + ".") for p in prefixes):
            return family
    return "other"


def sass_counts(library: str):
    """{kernel: {"total": SASS instructions in its code, "opcodes": the
    eight most frequent base opcodes and their counts, "families": the
    count of each of SASS_FAMILIES}} of a built library, read from
    `cuobjdump -sass`; None where the toolkit has no cuobjdump."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", library], check=True,
                          capture_output=True, text=True).stdout
    counts = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        short = next((k for k in ("blake2b_words_kernel", "subntt_kernel",
                                  "twiddle_outer_kernel") if k in name), name)
        table = re.search(r"Quotients([A-Z][a-z]+)", name)
        if "quotients_kernel" in name and table:
            short = f"quotients_kernel<{table.group(1)}>"
        full = re.findall(
            r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            chunk, flags=re.M)
        opcodes = collections.Counter(op.split(".")[0] for op in full)
        counts[short] = {"total": sum(opcodes.values()),
                         "opcodes": dict(opcodes.most_common(8)),
                         "families": dict(collections.Counter(
                             sass_family(op) for op in full))}
    return counts


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over `reps` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


_L2_FLUSH = []


def graph_ms(fn, calls: int = 10, replays: int = 3) -> float:
    """Device time of one fn() call, without the host's share: `calls`
    calls captured in one CUDA graph, each after a write of 128 MB that
    flushes the 50 MB L2 cache, the graph replayed `replays` times between
    two events, less the same graph of the flushes alone. fn's launches
    and allocations happen at capture (its launch counts rise by `calls`)."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(1 << 24, dtype=torch.int64,
                                     device="cuda"))
    flush = _L2_FLUSH[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    times = []
    for body in (lambda: (flush.fill_(1), fn()), lambda: flush.fill_(1)):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                body()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / (calls * replays))
        del graph
    return times[0] - times[1]


def random_messages(n: int, W: int, msg_len: int, seed: int):
    """(n, W) int64 words with full 64-bit random payload, zero past
    msg_len bytes, made on the card from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo = torch.randint(0, 1 << 32, (n, W), generator=g, device="cuda")
    hi = torch.randint(0, 1 << 32, (n, W), generator=g, device="cuda")
    words = (hi << 32) | lo
    nwords = (msg_len + 7) // 8
    words[:, nwords:] = 0
    if msg_len % 8:
        keep = (1 << (8 * (msg_len % 8))) - 1
        words[:, nwords - 1] &= keep
    return words.contiguous()


def max_abs_err(a, b) -> float:
    """Largest |a - b| over u64 words (0.0 when identical)."""
    from stark_brainfuck_tpu_torch.convert import tensor_to_u64

    diff = (a != b).any(dim=1)
    if not bool(diff.any()):
        return 0.0
    ah = tensor_to_u64(a[diff]).astype(object)
    bh = tensor_to_u64(b[diff]).astype(object)
    return float(max(abs(int(x) - int(y)) for x, y in zip(ah.ravel(), bh.ravel())))


def check_b1():
    from stark_brainfuck_tpu_torch.convert import tensor_to_u64
    from stark_brainfuck_tpu_torch.ops import blake2b as B

    results = []
    for k, (n, W, msg_len) in enumerate(B1_SHAPES):
        words = random_messages(n, W, msg_len, seed=k)
        got = B.blake2b_words(words, msg_len)
        plain = B.blake2b_words_plain(words, msg_len)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        assert err == 0.0, f"B1 differs from plain torch at {(n, W, msg_len)}"
        rows = sorted({0, n - 1, *range(0, n, max(1, n // 61))})
        host_words = tensor_to_u64(words[rows])
        host_dig = tensor_to_u64(got[rows])
        for r in range(len(rows)):
            payload = host_words[r].astype("<u8").tobytes()[:msg_len]
            want = hashlib.blake2b(payload).digest()
            assert host_dig[r].astype("<u8").tobytes() == want, (
                f"B1 differs from hashlib at {(n, W, msg_len)} row {rows[r]}"
            )
        ms = cuda_ms(lambda: B.blake2b_words(words, msg_len), reps=20)
        plain_ms = cuda_ms(lambda: B.blake2b_words_plain(words, msg_len), reps=3)
        bound_ms, bound_by = bound((W * 8 + 64) * n,
                                   n * (W // 16) * OPS_PER_COMPRESSION)
        row = {
            "n": n, "W": W, "msg_len": msg_len, "max_abs_err": err,
            "hashlib_rows": len(rows), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit("b1_check", **row)
        results.append(row)
        del words, got, plain
    return results


def bound(nbytes: float, ops: Ops):
    """(bound ms, what bounds it): the larger of the bytes over HBM
    bandwidth and each integer pipe's instructions over its issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops.alu, ops.fma) / PIPE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def subntt_ops(m: int) -> int:
    """Fewest 32-bit integer instructions of one m-point radix-2 NTT row.
    Every butterfly adds and subtracts. Its multiply by the twiddle
    w_{2h}^j (j < h, in the stage of half-width h) is no work for j = 0,
    a reduction only when the twiddle is a 64th root of unity (the field's
    are the powers of 8 = 2^3, so the product is a shift), and a full
    multiply otherwise."""
    ops, half = Ops(), 1
    while half < m:
        # j < h with w_{2h}^j a 64th root of unity: 64 j a multiple of 2h
        pow2 = half if 2 * half <= 64 else 32
        ops += (m // (2 * half)) * (
            (pow2 - 1) * GL_POW2_MUL_OPS + (half - pow2) * GL_MUL_OPS
            + half * (GL_ADD_OPS + GL_SUB_OPS)
        )
        half *= 2
    return ops


def random_field(rows: int, n: int, seed: int):
    """(rows, n) canonical Goldilocks words made on the card from a seed,
    with 0, 1 and p-1 first and p-1 last."""
    from stark_brainfuck_tpu_torch.convert import to_i64
    from stark_brainfuck_tpu_torch.ops import field as f

    g = torch.Generator(device="cuda").manual_seed(seed)
    lo = torch.randint(0, 1 << 32, (rows, n), generator=g, device="cuda")
    hi = torch.randint(0, 1 << 32, (rows, n), generator=g, device="cuda")
    x = f.from_u64_mod_p((hi << 32) | lo)
    del lo, hi
    flat = x.view(-1)
    p1 = to_i64(f.P - 1)
    flat[:3] = torch.tensor([0, 1, p1], device="cuda")
    flat[-1] = p1
    return x


def b2_forms(plan, k):
    """B2's launches for k rows of the plan's n: (form, sub-plan, batches,
    vectors, source strides, destination strides). `columns` and
    `rows_transposed` are the two passes as `ntt_kernel` launches them,
    `contiguous_*` the plain `subntt` form at the same sizes."""
    from stark_brainfuck_tpu_torch.ops.kernel_ntt import Strides

    n, r, c = plan.n, plan.r, plan.c
    return [
        ("columns", plan.sub_c, k, r, Strides(n, 1, r), Strides(n, 1, r)),
        ("rows_transposed", plan.sub_r, k, c, Strides(n, r, 1),
         Strides(n, 1, c)),
        ("contiguous_c", plan.sub_c, 1, k * r, Strides(0, c, 1),
         Strides(0, c, 1)),
        ("contiguous_r", plan.sub_r, 1, k * c, Strides(0, r, 1),
         Strides(0, r, 1)),
    ]


def check_b2_every_size():
    """B2 against its plain version at every size it takes, m = 2 .. 2^13,
    forward and inverse (scaled by m^-1): 5 contiguous rows, and 2 batches
    of 12 vectors in the column form and in the transposed-store form,
    which leave the last tile ragged. Exact, or it raises."""
    from stark_brainfuck_tpu_torch.ops import field as f
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as K

    cases, kappas = 0, set()
    for log_m in range(1, 14):
        m = 1 << log_m
        for inverse in (False, True):
            root = f.primitive_nth_root(m)
            sub = K._sub_plan(m, f.h_inverse(root) if inverse else root,
                              f.h_inverse(m) if inverse else 1, "cuda")
            kappas.add(sub.kappa)
            x = random_field(5, m, 200 + log_m)
            assert torch.equal(K.subntt(x, sub), K.subntt_plain(x, sub)), (
                f"B2 differs from plain torch at 5 rows of {m}")
            B, nvec = 2, 12
            n = m * nvec
            x = random_field(B, n, 300 + log_m)
            for src, dst in ((K.Strides(n, 1, nvec), K.Strides(n, 1, nvec)),
                             (K.Strides(n, m, 1), K.Strides(n, 1, nvec))):
                got = K.subntt_tiled(x, sub, B, nvec, src, dst)
                want = K.subntt_tiled_plain(x, sub, B, nvec, src, dst)
                assert torch.equal(got, want), (
                    f"B2 differs from plain torch at m = {m}, {src} -> {dst}")
            cases += 3
    torch.cuda.synchronize()
    emit("b2_every_size", sizes=13, cases=cases, kappas=sorted(kappas),
         max_abs_err=0.0)


def check_ntt_kernels():
    """B2 and B3 against their plain versions at the full-size prove's
    four-step shapes, then the composed transform against the u64
    network. Returns (b2 rows, b3 rows)."""
    from stark_brainfuck_tpu_torch.ops import field as f
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as K
    from stark_brainfuck_tpu_torch.ops import ntt as nt

    n = 1 << LOG2_FRI
    omega = f.primitive_nth_root(n)
    plan = K.make_kernel_plan(n, omega, False, "cuda")
    assert (plan.r, plan.c, plan.tw_hi.shape[0]) == (2048, 1024, 8)
    b2, b3 = [], []
    seed = 100
    for stage, k in NTT_ROWS.items():
        for form, sub, batches, nvec, src, dst in b2_forms(plan, k):
            m = sub.m
            seed += 1
            x = random_field(batches * nvec, m, seed)
            if form.startswith("contiguous"):
                got = K.subntt(x, sub)
                plain = K.subntt_plain(x, sub)
                run = lambda: K.subntt(x, sub)
                run_plain = lambda: K.subntt_plain(x, sub)
            else:
                got = K.subntt_tiled(x, sub, batches, nvec, src, dst)
                plain = K.subntt_tiled_plain(x, sub, batches, nvec, src, dst)
                run = lambda: K.subntt_tiled(x, sub, batches, nvec, src, dst)
                run_plain = lambda: K.subntt_tiled_plain(
                    x, sub, batches, nvec, src, dst)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain)
            assert err == 0.0, f"B2 differs from plain torch at {(form, stage)}"
            del got, plain
            ms = cuda_ms(run, reps=20)
            plain_ms = cuda_ms(run_plain, reps=3)
            rows = batches * nvec
            bound_ms, bound_by = bound(16 * rows * m + 8 * sub.table.numel(),
                                       rows * subntt_ops(m))
            row = {"stage": stage, "form": form, "rows": rows, "m": m,
                   "tile": K.tile_shape(m, src.elem != 1 or dst.elem != 1),
                   "kappa": sub.kappa, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            emit("b2_check", **row)
            b2.append(row)
            del x
    for stage, k in NTT_ROWS.items():
        rows, r = k * plan.c, plan.r
        seed += 1
        y = random_field(rows, r, seed)
        got = K.twiddle_outer(y, plan)
        plain = K.twiddle_outer_plain(y, plan)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        assert err == 0.0, f"B3 differs from plain torch at {(rows, r)}"
        del got, plain
        ms = cuda_ms(lambda: K.twiddle_outer(y, plan), reps=20)
        plain_ms = cuda_ms(lambda: K.twiddle_outer_plain(y, plan), reps=3)
        tables = 8 * (128 + plan.c // 128) * r
        bound_ms, bound_by = bound(16 * rows * r + tables,
                                   2 * GL_MUL_OPS * rows * r)
        row = {"stage": stage, "rows": rows, "r": r, "c": plan.c,
               "hi_rows": plan.c // 128, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        emit("b3_check", **row)
        b3.append(row)
        del y
    pack = nt.make_pack(n, omega, False, "cuda")
    for stage, k in NTT_ROWS.items():
        seed += 1
        v = random_field(k, n, seed)
        got = K.ntt_kernel(v, plan)
        want = nt.ntt_with(v, pack)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        assert err == 0.0, f"ntt_kernel differs from the u64 network at {(k, n)}"
        del got, want
        kernel_ms = cuda_ms(lambda: K.ntt_kernel(v, plan), reps=20)
        u64_ms = cuda_ms(lambda: nt.ntt_with(v, pack), reps=5)
        # the least the transform can move: no 2^21-point row fits an SM,
        # so the block of rows is read and written twice
        bound_ms, _ = bound(2 * 16 * k * n, Ops())
        emit("ntt_full", stage=stage, rows=k, n=n, r=plan.r, c=plan.c,
             max_abs_err=err, kernel_ms=kernel_ms, u64_ms=u64_ms,
             bound_ms=bound_ms)
        del v
    return b2, b3


# ---------------------------------------------------------------------------
# F1, F2, F3: the field layer's kernels (csrc/field.cu)
# ---------------------------------------------------------------------------

# the field words the exactness checks pair up: the edge values of the CPU
# tests, and for F1, whose plain version is defined on any u64 words, three
# words from p up
FIELD_EDGES = (0, 1, 0xFFFFFFFF00000000, 2**32 - 1, 2**32, 2**32 + 1,
               2**63 % 0xFFFFFFFF00000001, 0xFFFFFFFEFFFFFFFF)
F1_EDGES = FIELD_EDGES + (0xFFFFFFFF00000001, 0xFFFFFFFF00000002, 2**64 - 1)
# 32-bit instructions an element of the F_p^3 multiply: 9 multiplies, 6
# adds, 2 subs (`xf_mul`)
XF_MUL_OPS = 9 * GL_MUL_OPS + 6 * GL_ADD_OPS + 2 * GL_SUB_OPS
# F3, counted on the schedule of csrc/field.cu (fewer than the 7 multiplies
# and 6 adds a base term, 13 and 14 an extension term, counted before its
# redesign, which was therefore no lower bound). A term at one position,
# extension: its coefficient w_shift·start·r^tile0 · r^j + w_plain (3
# multiplies, 3 adds), y's multiplication matrix (y0 + y2, y1 - y2 and two
# negations, 2 each) and 9 products; base: r^j·y (1 multiply) and 6
# products, w_shift·start·r^tile0·(r^j y) and w_plain·y. A product summed
# unreduced is 4 wide multiply-adds of its 32-bit halves into the even and
# odd sums (the add comes with the multiply) and 3 carry adds. A position,
# once a launch: each of the 3 sums' reduction (two 128-bit ones, 10 each,
# two subs of a top word and their add) and the 3 adds into acc
ACC_MAC_OPS = Ops(3, 4)
ACC_REDUCE_OPS = Ops(2 * 10) + 2 * GL_SUB_OPS + GL_ADD_OPS
ACC_TERM_OPS = {False: GL_MUL_OPS + 6 * ACC_MAC_OPS,
                True: 3 * GL_MUL_OPS + 3 * GL_ADD_OPS + GL_ADD_OPS
                + GL_SUB_OPS + Ops(2 * 2) + 9 * ACC_MAC_OPS}
ACC_POSITION_OPS = 3 * ACC_REDUCE_OPS + 3 * GL_ADD_OPS
# F3 before its redesign, at the shapes PERF.md holds its times for
# (NVIDIA H100 80GB HBM3, 700.00 W; `graph_ms`): {group: ms}
F3_BASELINE_MS = {"quotients": 1.2709, "base": 0.5817, "ext": 0.5554,
                  "streamed ext": 0.0891}
# the u64 network's stage whose twiddle broadcast F1 is timed at: blocks of
# 2^11 words, the odd half times tw[None, None, :]
F1_TWIDDLE_LOG2_BLOCK = 11


def acc_tables():
    """[(base columns, extension columns, quotients, rows > 0)] of each
    table of the prove, from a stark of "++++" (whose input and output
    tables are empty, as the counter's are); the counts do not depend on
    the program or the challenges."""
    bfs, _ = make_stark("++++", 0, "cpu")
    one = [(1, 0, 0)]
    return [(t.base_width, t.num_ext_columns,
             len(t.all_quotient_degree_bounds(one * 11, one * 5)),
             t.height > 0) for t in bfs.tables]


def acc_stacks(tables, n, seed, streamed):
    """The prove's eight F3 groups at n positions, in the layouts the
    prover hands them over: {group: (parts, extension?)}. Resident, the
    base group is one row slice of the base LDE block (3 randomizer rows,
    then the columns) a table and the extension group one `movedim` view
    of the extension LDE's rows a table, an empty table's columns a
    zero-stride view; a streamed class the same groups as one view each of
    `block_values`' rows; each table's quotients and the two permutation
    quotients a contiguous (T, n, 3) stack."""
    num_base = sum(t[0] for t in tables)
    num_ext = sum(t[1] for t in tables)
    block = random_field(3 + num_base, n, seed)
    rows = random_field(3 * num_ext, n, seed + 1).view(num_ext, 3, n)
    if streamed:
        base, ext = [block[3:]], [rows.movedim(1, -1)]
    else:
        base, ext, b0, e0 = [], [], 3, 0
        for width, n_ext, _, filled in tables:
            base.append(block[b0:b0 + width])
            ext.append(rows[e0:e0 + n_ext].movedim(1, -1) if filled else
                       block.new_zeros(()).expand(n_ext, n, 3))
            b0, e0 = b0 + width, e0 + n_ext
    groups = {"base": (base, False), "ext": (ext, True)}
    for i, (_, _, quotients, _) in enumerate(tables):
        stack = random_field(quotients * n, 3, seed + 2 + i)
        groups[f"quotients {i}"] = ([stack.view(quotients, n, 3)], True)
    groups["permutation"] = ([random_field(2 * n, 3, seed + 9).view(2, n, 3)],
                             True)
    return groups


def edge_words(words):
    from stark_brainfuck_tpu_torch.convert import u64_to_tensor

    return u64_to_tensor(list(words), "cuda")


def field_case(kernel, run, run_plain, nbytes, ops, timed=None, reps=20,
               time_plain=True, **at):
    """One shape of F1, F2 or F3: the kernel, launched once and counted,
    against its plain version on the same card tensors, exactly. Times of
    `timed` (the kernel alone, `run` by default) and of the plain version:
    ms and plain_ms their device time a call (`graph_ms`, cold L2),
    call_ms and plain_call_ms CUDA events around one call from the host
    (the host's share included, as a caller sees it); and the bound of the
    work. F3's launch comes with one of its power tables."""
    reset_counts()
    got = run()
    counts = read_counts()
    want = {kernel: 1, **({"f3_powers": 1} if kernel == "f3" else {})}
    assert counts == {**{k: 0 for k in counts}, **want}, (kernel, at, counts)
    want = run_plain()
    torch.cuda.synchronize()
    assert got.shape == want.shape, (kernel, at, got.shape, want.shape)
    err = max_abs_err(got.reshape(-1, 1), want.reshape(-1, 1))
    assert err == 0.0, f"{kernel} differs from its plain version at {at}"
    del got, want
    bound_ms, bound_by = bound(nbytes, ops)
    row = {"kernel": kernel, **at, "max_abs_err": err,
           "ms": graph_ms(timed or run),
           "plain_ms": graph_ms(run_plain, calls=1) if time_plain else None,
           "call_ms": cuda_ms(timed or run, reps=reps),
           "plain_call_ms": cuda_ms(run_plain, reps=3) if time_plain else None,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit("field_kernels", **row)
    return row


def field_kernels():
    """F1, F2 and F3 against their plain versions on the card, exactly, at
    the full-size prove's shapes (FRI 2^21) and on edge values. F1: add,
    sub and mul of two 2^21-word codewords, the u64 network's twiddle
    broadcast, every pair of edge words. F2: mul of (2^21, 3) extension
    codewords, contiguous and in the strided layout of the extension LDE's
    columns (`movedim`), mul_base, every pair of edge elements. F3
    (`f3_case`): every group of the prove (`acc_stacks`) resident at N =
    2^21 and as a streamed class at S = 2^17 and 2^21, ragged n, one term,
    and a group of edge weights, ratios and starts. Returns {kernel:
    [rows]}."""
    from stark_brainfuck_tpu_torch.ops import field as F
    from stark_brainfuck_tpu_torch.ops import field_kernels as FK
    from stark_brainfuck_tpu_torch.ops import xfield as X
    from stark_brainfuck_tpu_torch.protocol.stark import BrainfuckStark

    n = 1 << LOG2_FRI
    rows = {"f1": [], "f2": [], "f3": []}
    ops = {"add": (F.add, F.add_plain, GL_ADD_OPS),
           "sub": (F.sub, F.sub_plain, GL_SUB_OPS),
           "mul": (F.mul, F.mul_plain, GL_MUL_OPS)}
    a, b = random_field(2, n, 300)
    for name, (fn, plain, per) in ops.items():
        rows["f1"].append(field_case(
            "f1", lambda: fn(a, b), lambda: plain(a, b), 24 * n, per * n,
            op=name, shape=[n], form="contiguous"))
    half = 1 << (F1_TWIDDLE_LOG2_BLOCK - 1)
    x = random_field(NTT_ROWS["ext"], n, 301).view(NTT_ROWS["ext"], -1,
                                                   2 * half)
    odd, tw = x[:, :, half:], random_field(1, half, 302)[0][None, None, :]
    rows["f1"].append(field_case(
        "f1", lambda: F.mul(odd, tw), lambda: F.mul_plain(odd, tw),
        16 * odd.numel() + 8 * half, GL_MUL_OPS * odd.numel(), op="mul",
        shape=list(odd.shape), form="twiddle broadcast tw[None, None, :]"))
    del x, odd
    e = edge_words(F1_EDGES)
    ea, eb = e.repeat_interleave(e.numel()), e.repeat(e.numel())
    for name, (fn, plain, per) in ops.items():
        rows["f1"].append(field_case(
            "f1", lambda: fn(ea, eb), lambda: plain(ea, eb), 24 * ea.numel(),
            per * ea.numel(), reps=5, op=name, shape=[ea.numel()],
            form="edge word pairs"))

    xa, xb = random_field(3, n, 310).T, random_field(3, n, 311).T.contiguous()
    base = random_field(1, n, 312)[0]
    xa_c = xa.contiguous()
    for form, lhs in (("contiguous", xa_c),
                      ("strided columns (movedim)", xa)):
        rows["f2"].append(field_case(
            "f2", lambda: X.mul(lhs, xb), lambda: X.mul_plain(lhs, xb),
            72 * n, XF_MUL_OPS * n, op="mul", shape=[n, 3], form=form))
    rows["f2"].append(field_case(
        "f2", lambda: X.mul_base(xa_c, base),
        lambda: X.mul_base_plain(xa_c, base), 56 * n, 3 * GL_MUL_OPS * n,
        op="mul_base", shape=[n, 3], form="contiguous"))
    del xa, xb, xa_c, base
    x3 = edge_words(FIELD_EDGES)
    x3 = torch.stack(torch.meshgrid(x3, x3, x3, indexing="ij"),
                     dim=-1).reshape(-1, 3)
    pa, pb = x3.repeat_interleave(x3.shape[0], 0), x3.repeat(x3.shape[0], 1)
    rows["f2"].append(field_case(
        "f2", lambda: X.mul(pa, pb), lambda: X.mul_plain(pa, pb),
        72 * pa.shape[0], XF_MUL_OPS * pa.shape[0], reps=5, op="mul",
        shape=list(pa.shape), form="edge element pairs"))
    pw = pb[:, 0].contiguous()
    rows["f2"].append(field_case(
        "f2", lambda: X.mul_base(pa, pw), lambda: X.mul_base_plain(pa, pw),
        56 * pa.shape[0], 3 * GL_MUL_OPS * pa.shape[0], reps=5,
        op="mul_base", shape=list(pa.shape), form="edge element pairs"))
    del x3, pa, pb, pw

    stark = BrainfuckStark.__new__(BrainfuckStark)  # `_acc_group` reads no state
    tables = acc_tables()
    sizes = [(n, "resident", False), (STREAM_S, "streamed class", True),
             (n, "streamed class", True)]
    # the groups timed before F3's redesign: resident base, ext and the
    # largest quotient group, and a streamed class's ext group at S = 2^17
    big = max(range(len(tables)), key=lambda i: tables[i][2])
    baseline = {("resident", "base"): "base", ("resident", "ext"): "ext",
           ("resident", f"quotients {big}"): "quotients",
           ("streamed class", "ext", STREAM_S): "streamed ext"}
    seed = 320
    for length, form, streamed in sizes:
        groups = acc_stacks(tables, length, seed, streamed)
        for group, (parts, ext) in groups.items():
            seed += 10
            key = (baseline.get((form, group))
                   or baseline.get((form, group, length)))
            rows["f3"].append(f3_case(
                stark, parts, ext, length, seed, time_plain=key is not None,
                group=group, form=form, baseline_shape=key,
                baseline_ms=F3_BASELINE_MS.get(key)))
        del groups
    # ragged n, one term, and edge weights, ratios (0, 1, p - 1 among them)
    # and starts
    for length, terms, ext in (((1 << 17) + 37, 9, True), (1000, 16, False),
                               (1000, 21, True), (n, 1, False),
                               (STREAM_S, 1, True)):
        seed += 10
        stack = (random_field(terms * length, 3, seed).view(terms, length, 3)
                 if ext else random_field(terms, length, seed))
        rows["f3"].append(f3_case(
            stark, [stack], ext, length, seed, time_plain=False,
            group=f"{terms} terms", form="ragged n" if length % 256 else
            "one term"))
        del stack
    terms = len(FIELD_EDGES)
    e = edge_words(FIELD_EDGES)
    stack = random_field(terms * 4096, 3, 401).view(terms, 4096, 3)
    w = torch.stack([e.roll(k) for k in range(6)], dim=-1).view(terms, 2, 3)
    rows["f3"].append(f3_case(
        stark, [stack], True, 4096, 400, time_plain=False,
        weights=(w, e, e.roll(3)), group="edges",
        form="edge weights, ratios and starts"))
    return rows


def f3_case(stark, parts, ext, length, seed, time_plain, weights=None,
            **at):
    """F3 on one group (`parts`, the group's terms where they lie) at
    `length` positions through `_acc_group`, launched once and counted,
    against `_acc_group_plain` on the concatenated stack, exactly; then at
    every term split the plan allows, each held to the same result and
    timed (`graph_ms`). The row: the field_case times (the plain version's
    only where `time_plain`), the card's plan (`acc_plan`: groups,
    positions and blocks, blocks an SM holds, registers), which must equal
    `acc_geometry`'s rule for the card's slots, and the bound: each stack
    word read once (a zero-stride part reads none), acc read and written,
    the tables written and read, and the operations of ACC_TERM_OPS and
    ACC_POSITION_OPS."""
    from stark_brainfuck_tpu_torch.ops import field_kernels as FK

    terms = sum(int(q.shape[0]) for q in parts)
    acc = random_field(length, 3, seed)
    if weights is None:
        w = random_field(terms * 2, 3, seed + 2).view(terms, 2, 3)
        # 0, 1 and p - 1 among the first ratios
        words = random_field(1, 2 * terms + 2, seed + 3)[0]
        ratios, starts = words[:terms], words[terms:2 * terms]
    else:
        w, ratios, starts = weights
    stack = torch.cat([q.contiguous() for q in parts], dim=0)
    scratch = acc.clone()
    plan = FK.acc_plan(ext, terms, length)
    slots = plan["sms"] * plan["blocks_per_sm"]
    assert FK.acc_geometry(terms, length, slots) == (
        plan["log_groups"], plan["positions_per_block"], plan["blocks"]), plan
    read = sum(q.numel() * 8 for q in parts if q.stride()[0])
    table = 8 * terms * FK.acc_table_words(length)
    want = stark._acc_group_plain(acc, stack, w, ratios, starts,
                                  length=length)
    by_split = {}
    for lg in range(FK.ACC_LOG_MAX_GROUPS + 1):
        if 1 << lg > terms:
            break
        got = FK.acc_group(acc.clone(), parts, w, ratios, starts, length, lg)
        assert torch.equal(got, want), f"F3 differs at split {lg}, {at}"
        by_split[1 << lg] = graph_ms(lambda lg=lg: FK.acc_group(
            scratch, parts, w, ratios, starts, length, lg))
        del got
    del want
    row = field_case(
        "f3",
        lambda: stark._acc_group(acc.clone(), parts, w, ratios, starts,
                                 length=length),
        (lambda: stark._acc_group_plain(acc, stack, w, ratios, starts,
                                        length=length)),
        read + 48 * length + 2 * table + 64 * terms,
        (ACC_TERM_OPS[ext] * terms + ACC_POSITION_OPS) * length,
        timed=lambda: FK.acc_group(scratch, parts, w, ratios, starts, length),
        time_plain=time_plain, terms=terms, n=length, ext=ext,
        parts=[list(q.shape) for q in parts],
        strides=[list(q.stride()) for q in parts], plan=plan,
        ms_by_groups=by_split, **at)
    del acc, stack, scratch
    return row


# ---------------------------------------------------------------------------
# F4: each table's quotients in one launch (csrc/quotients.cu)
# ---------------------------------------------------------------------------

# the streamed class the quotient_kernel phase cuts from the resident LDE:
# class 1 of 16 at FRI 2^21, S = 2^17 positions, as a 32-class prove at FRI
# 2^22 hands F4 its classes
QUOTIENT_CLASSES = 16


def quotient_work(tables, n: int):
    """(bytes, Ops) of F4 on `tables` (table objects of a stark) at n
    positions, from each table's lowered program (`quotient_kernels.
    row_counts`): each column and zerofier word read once, each output
    word written once, and the Goldilocks multiplies, adds and subs of a
    position (the values that depend on no column, once a block, left
    out)."""
    from stark_brainfuck_tpu_torch.ops import quotient_kernels as QK

    nbytes, ops = 0, Ops()
    for t in tables:
        c = QK.row_counts(QK.lower(QK.program(t)))
        nbytes += 8 * (c["read"] + c["written"]) * n
        ops += (c["mul"] * GL_MUL_OPS + c["add"] * GL_ADD_OPS
                + c["sub"] * GL_SUB_OPS) * n
    return nbytes, ops


def quotient_dispatches(bfs, evaluations: int = 1):
    """{"f1": F1 launches, "f2": F2 launches} that `evaluations` op-by-op
    evaluations of the five tables' quotient stacks make (`interp.
    dispatches` of each table's program): the launches F4 replaces."""
    from stark_brainfuck_tpu_torch.models.interp import dispatches
    from stark_brainfuck_tpu_torch.ops import quotient_kernels as QK

    d = [dispatches(QK.program(t)) for t in bfs.tables]
    return {"f1": evaluations * sum(x["add"] + x["sub"] + x["mul"] for x in d),
            "f2": evaluations * sum(x["xmul"] + x["xmul_base"] for x in d)}


def plain_quotients(bfs):
    """bfs with its quotient stacks evaluated op by op (F1/F2), the form
    F4 replaced: the baseline of the stage_c comparisons."""
    bfs._table_quotient_stack = bfs._table_quotient_stack_plain
    return bfs


def quotient_kernel(src, smi):
    """F4 against `_table_quotient_stack_plain` (`Table.quotients` op by op
    on F1/F2) on the card, exactly, for all five tables, on the 2^15-cycle
    counter's own operands: one prove records every `_table_quotient_stack`
    call (the LDE's column views, the challenges and terminals, the
    zerofier inverses). Three forms: resident at N = 2^21 (the next row at
    the unit distance), a streamed class (class 1 of QUOTIENT_CLASSES, S =
    N / B, the row shift ud / B, in the streamed prover's layouts), and the
    next row as columns rolled by the caller with rot 0 (the mesh's form;
    the ranks run it in mesh_kernels). Each table's launch is counted (one
    F4, no F1/F2), timed (`graph_ms`, cold L2; `call_ms` CUDA events from
    the host) beside the plain stack (CUDA events: it allocates host
    constants, which a graph cannot capture), with its bound
    (`quotient_work`); an "all five" row per form sums one evaluation.
    Returns the rows."""
    from stark_brainfuck_tpu_torch.ops import quotient_kernels as QK

    bfs, args = make_stark(src, 0, "cuda")
    calls = []
    inner = bfs._table_quotient_stack

    def record(ti, *operands, **kw):
        calls.append((ti, operands))
        return inner(ti, *operands, **kw)

    bfs._table_quotient_stack = record
    proof = bfs.prove(*args)
    del bfs._table_quotient_stack
    assert bfs.verify(proof), bfs.last_rejection
    assert [c[0] for c in calls] == list(range(5)), [c[0] for c in calls]
    N = bfs.fri.domain.length
    B = QUOTIENT_CLASSES

    def cls(x):
        """Class 1's positions of a column group or a zerofier inverse,
        in the streamed prover's layouts: base columns as contiguous rows
        and extension columns as the `movedim` view of contiguous (n_ext,
        3, S) rows (`block_values`), the zerofier inverses as the strided
        gather `_stream_zinv_block` makes."""
        if x.dim() == 2:
            return x[:, 1::B].contiguous()
        if x.dim() == 3:
            return x[:, 1::B].movedim(-1, 1).contiguous().movedim(1, -1)
        return x[1::B] if x.dim() else x

    forms = {}
    for ti, (base, ext, ch, tm, zinv) in calls:
        t = bfs.tables[ti]
        ud = t.unit_distance(N)
        assert ud % B == 0, (t.name, ud)
        rolled = (torch.roll(base, -ud, 1), torch.roll(ext, -ud, 1))
        forms.setdefault("resident", []).append((
            lambda ti=ti, o=(base, ext, ch, tm, zinv): bfs._table_quotient_stack(
                ti, *o),
            lambda ti=ti, o=(base, ext, ch, tm, zinv):
                bfs._table_quotient_stack_plain(ti, *o), N, t))
        zc = {k: cls(v) for k, v in zinv.items()}
        forms.setdefault("streamed class", []).append((
            lambda ti=ti, o=(cls(base), cls(ext), ch, tm, zc), u=ud // B:
                bfs._table_quotient_stack(ti, *o, ud=u),
            lambda ti=ti, o=(cls(base), cls(ext), ch, tm, zc), u=ud // B:
                bfs._table_quotient_stack_plain(ti, *o, ud=u), N // B, t))
        forms.setdefault("rolled next, rot 0", []).append((
            lambda ti=ti, o=(base, ext, ch, tm, zinv), r=rolled:
                QK.quotient_stack(ti, bfs._quotient_program(ti), *o, 0, *r),
            lambda ti=ti, o=(base, ext, ch, tm, zinv):
                bfs._table_quotient_stack_plain(ti, *o), N, t))
    rows = []
    for form, cases in forms.items():
        for run, run_plain, n, t in cases:
            reset_counts()
            got = run()
            counts = read_counts()
            assert counts == {**{k: 0 for k in counts}, "f4": 1}, (
                form, t.name, counts)
            want = run_plain()
            torch.cuda.synchronize()
            assert got.shape == want.shape, (form, t.name, got.shape)
            err = max_abs_err(got.reshape(-1, 1), want.reshape(-1, 1))
            assert err == 0.0, f"F4 differs from the plain stack: {form}, {t.name}"
            del got, want
            nbytes, ops = quotient_work([t], n)
            bound_ms, bound_by = bound(nbytes, ops)
            row = {"kernel": "f4", "form": form, "table": t.name, "n": n,
                   "quotients": len(QK.program(t).outputs),
                   "max_abs_err": err, "ms": graph_ms(run),
                   "plain_ms": cuda_ms(run_plain, reps=3),
                   "call_ms": cuda_ms(run, reps=10),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes": nbytes, "ops": ops.as_dict()}
            emit("quotient_kernel", **row)
            rows.append(row)
        n = cases[0][2]
        nbytes, ops = quotient_work(bfs.tables, n)
        bound_ms, bound_by = bound(nbytes, ops)
        every = [r for r in rows if r["form"] == form]

        def all_five(fns):
            for fn in fns:
                fn()

        row = {"kernel": "f4", "form": form, "table": "all five", "n": n,
               "quotients": sum(r["quotients"] for r in every),
               "max_abs_err": 0.0,
               "ms": graph_ms(lambda: all_five([c[0] for c in cases])),
               "plain_ms": cuda_ms(
                   lambda: all_five([c[1] for c in cases]), reps=3),
               "call_ms": cuda_ms(lambda: all_five([c[0] for c in cases]),
                                  reps=10),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "ops": ops.as_dict(), "nvidia_smi": smi}
        emit("quotient_kernel", **row)
        rows.append(row)
    del calls, forms, bfs
    return rows


def b2_sweep():
    """Times B2's two four-step passes and the whole transform at the
    extension shape (27 rows of 2^21) under several tile shapes (the
    LOG_TILE and LOG_TI_STRIDED of ops/kernel_ntt.py), each held equal to
    the first one's output. A tuning aid, not a check."""
    from stark_brainfuck_tpu_torch.ops import field as f
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as K

    n, k = 1 << LOG2_FRI, NTT_ROWS["ext"]
    plan = K.make_kernel_plan(n, f.primitive_nth_root(n), False, "cuda")
    v = random_field(k, n, 7)
    want = None
    defaults = (K.LOG_TILE, K.LOG_TI_STRIDED)
    try:
        for shape in [defaults, (12, 3), (13, 3), (11, 2), (11, 1), defaults]:
            K.LOG_TILE, K.LOG_TI_STRIDED = shape
            got = K.ntt_kernel(v, plan)
            want = got if want is None else want
            assert torch.equal(got, want), shape
            del got
            forms = {}
            for form, sub, batches, nvec, src, dst in b2_forms(plan, k)[:2]:
                forms[form] = {
                    "tile": K.tile_shape(sub.m, True),
                    "ms": cuda_ms(lambda: K.subntt_tiled(
                        v, sub, batches, nvec, src, dst), reps=20)}
            emit("b2_sweep", log_tile=shape[0], log_ti_strided=shape[1],
                 forms=forms,
                 ntt_kernel_ms=cuda_ms(lambda: K.ntt_kernel(v, plan), reps=20))
    finally:
        K.LOG_TILE, K.LOG_TI_STRIDED = defaults


# B2 with parts cut out of its source, to see what its time is made of:
# (name, [(text in csrc/ntt.cu, replacement), ...]). The outputs are wrong;
# only the times mean anything.
B2_PARTS = {
    # loads, exchanges, barriers and stores, no field arithmetic
    "no_arithmetic": [
        ("dft_pow2<R>(a + g * R);", ""),
        ("if (!LAST && jr != 0) b = gl_mul(b, __ldg(tw + ((jr - 1) << "
         "(log_n - LR))));", ""),
    ],
    # all the arithmetic and exchanges, no global loads or stores
    "no_global_memory": [
        ("copy_async8(dst + (k << log_bf), src + k * k_stride, valid);", ";"),
        ("if (vec < A.nvec) dst[j * j_stride] = b;",
         "if (b == 0x123456789ULL) dst[j * j_stride] = b;"),
    ],
}


def b2_parts():
    """Times B2 at the extension shape (27 rows of 2^21) as it is, then
    with its arithmetic cut out, then with its global memory traffic cut
    out, each variant built here from csrc/ntt.cu with the port's own nvcc
    flags; a torch copy of the same bytes beside them. Says which of the
    two bounds the kernel. A measuring aid, not a check."""
    import ctypes

    from stark_brainfuck_tpu_torch.ops import cuda_build
    from stark_brainfuck_tpu_torch.ops import field as f
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as K

    with open(os.path.join(cuda_build.CSRC_DIR, "ntt.cu")) as fh:
        source = fh.read()
    parts_dir = os.path.join(cuda_build.BUILD_DIR, "parts")
    os.makedirs(parts_dir, exist_ok=True)
    real = K._kernel_lib()
    libs = {"whole": real}
    for name, cuts in B2_PARTS.items():
        text = source
        for old, new in cuts:
            assert old in text, f"csrc/ntt.cu no longer has: {old}"
            text = text.replace(old, new)
        cu = os.path.join(parts_dir, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = cu[:-3] + ".so"
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                        cu], check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(so)
        lib.subntt_launch.argtypes = real.subntt_launch.argtypes
        lib.subntt_launch.restype = ctypes.c_int
        libs[name] = lib
    n, k = 1 << LOG2_FRI, NTT_ROWS["ext"]
    plan = K.make_kernel_plan(n, f.primitive_nth_root(n), False, "cuda")
    v = random_field(k, n, 7)
    w = torch.empty_like(v)
    emit("b2_parts", variant="torch_copy", bytes=16 * k * n,
         ms=cuda_ms(lambda: w.copy_(v), reps=20))
    try:
        for name in ("whole", *B2_PARTS, "whole"):
            K._LIB = libs[name]
            emit("b2_parts", variant=name, ms={
                form: cuda_ms(lambda: K.subntt_tiled(
                    v, sub, batches, nvec, src, dst), reps=20)
                for form, sub, batches, nvec, src, dst in b2_forms(plan, k)})
    finally:
        K._LIB = real


def counter_program(target_cycles: int) -> str:
    """Two-level counter: the largest program whose running time plus
    program length stays below `target_cycles`, so every table height
    stays inside the target power of two."""
    from stark_brainfuck_tpu_torch import VirtualMachine

    inner = "[->" + "+" * 32 + "[-]<]"

    def runtime(outer):
        program = VirtualMachine.compile("+" * outer + inner)
        rt, _, _ = VirtualMachine.run(program)
        return rt + len(program)

    lo, hi = 1, 1
    while runtime(hi) < target_cycles:
        lo, hi = hi, hi * 2
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if runtime(mid) < target_cycles:
            lo = mid
        else:
            hi = mid
    return "+" * lo + inner


def native_host(smi):
    """The host runtime (native/): the C++ trace recorder against the
    python one on the 2^16-cycle counter, alone on the 2^20-cycle one, and
    the C++ Merkle engine against hashlib. Host wall times."""
    import numpy as np

    from stark_brainfuck_tpu_torch import VirtualMachine
    from stark_brainfuck_tpu_torch.protocol import merkle as M

    # load both libraries, and start OpenMP's threads with a tree of 2^12
    # leaves, whose wide levels run in parallel regions
    VirtualMachine.simulate(VirtualMachine.compile("++"))
    M._build_nodes_buffer(bytes(NATIVE_TREE_PLEN << 12), NATIVE_TREE_PLEN,
                          1 << 12)
    recorder = {}
    for log2 in NATIVE_LOG2_CYCLES:
        program = VirtualMachine.compile(counter_program(1 << log2))
        t0 = time.time()
        trace = VirtualMachine.simulate(program)
        row = {"trace_cycles": int(trace["processor"].shape[0]),
               "cpp_s": time.time() - t0}
        assert row["trace_cycles"] + len(program) < 1 << log2, row
        if log2 == NATIVE_LOG2_CYCLES[0]:
            t0 = time.time()
            plain = VirtualMachine.simulate(program, native=False)
            row["python_s"] = time.time() - t0
            for key in ("processor", "memory", "instruction", "input",
                        "output"):
                assert np.array_equal(trace[key], plain[key]), key
            row["speedup"] = row["python_s"] / row["cpp_s"]
            assert row["speedup"] >= 10, row
        recorder[f"2^{log2}"] = row
    trees = []
    for count in NATIVE_TREE_LEAVES:
        buf = np.random.default_rng(count).integers(
            0, 256, count * NATIVE_TREE_PLEN, dtype=np.uint8).tobytes()
        cpp_s = []  # the first tree also takes its output's fresh pages
        for _ in range(NATIVE_SWEEP_REPS):
            t0 = time.time()
            nodes = M._build_nodes_buffer(buf, NATIVE_TREE_PLEN, count)
            cpp_s.append(time.time() - t0)
        t0 = time.time()
        want = M._build_nodes_python(
            [buf[i * NATIVE_TREE_PLEN:(i + 1) * NATIVE_TREE_PLEN]
             for i in range(count)], count)
        trees.append({"leaves": count, "payload_bytes": NATIVE_TREE_PLEN,
                      "cpp_first_s": cpp_s[0], "cpp_s": min(cpp_s),
                      "hashlib_s": time.time() - t0, "equal": nodes == want})
        assert nodes == want, f"host tree of {count} leaves differs"
    emit("native_host", recorder=recorder, trees=trees,
         parallel_min_sweep=tree_parallel_min_sweep(),
         cpu_count=os.cpu_count(), nvidia_smi=smi)


def tree_parallel_min_sweep():
    """The least of NATIVE_SWEEP_REPS host tree times (ms) for each level
    width from which the engine hashes a level in parallel, each a build of
    native/hashing.cpp of its own (all started together), each tree checked
    against the shipped engine's."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from stark_brainfuck_tpu_torch.ops import cuda_build
    from stark_brainfuck_tpu_torch.protocol import merkle as M

    with ThreadPoolExecutor(len(NATIVE_PARALLEL_MINS)) as pool:
        paths = list(pool.map(
            lambda m: cuda_build.build_host(
                ["hashing"], [f"MERKLE_PARALLEL_MIN={m}"])["hashing"],
            NATIVE_PARALLEL_MINS))
    out = {}
    for pmin, path in zip(NATIVE_PARALLEL_MINS, paths):
        fn = ctypes.CDLL(path).merkle_from_payloads
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                       ctypes.c_char_p]
        row = {}
        for count in NATIVE_SWEEP_LEAVES:
            buf = np.random.default_rng(count).integers(
                0, 256, count * NATIVE_TREE_PLEN, dtype=np.uint8).tobytes()
            nodes = ctypes.create_string_buffer(2 * count * M.HASH_LEN)
            times = []
            for _ in range(NATIVE_SWEEP_REPS):
                t0 = time.perf_counter()
                fn(buf, NATIVE_TREE_PLEN, count, nodes)
                times.append((time.perf_counter() - t0) * 1e3)
            assert nodes.raw == M._build_nodes_buffer(
                buf, NATIVE_TREE_PLEN, count), (pmin, count)
            row[str(count)] = min(times)
        out[str(pmin)] = row
    return out


def make_stark(src: str, seed: int, device, trace=None, **config):
    """(stark, prove arguments) for a program without input; `trace`, the
    program's recorded run, spares simulating it again."""
    from stark_brainfuck_tpu_torch import BrainfuckStark, StarkConfig, VirtualMachine

    program = VirtualMachine.compile(src)
    if trace is None:
        trace = VirtualMachine.simulate(program)
    bfs = BrainfuckStark(
        trace["processor"].shape[0], trace["memory"].shape[0], program, "",
        trace["output_data"], StarkConfig(seed=seed, **config), device=device,
    )
    args = (trace["processor"], trace["memory"], trace["instruction"],
            trace["input"], trace["output"])
    return bfs, args


def profile_prove(bfs, args, out_dir):
    """One prove under torch.profiler: device time by kernel name, the
    device's busy share of the wall time, and B1's and F1-F3's device time;
    the full table goes to out_dir/profile_prove.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        bfs.prove(*args)
        torch.cuda.synchronize()
        wall = time.time() - t0
    # device-side events only (kernels, copies): the aten:: rows carry the
    # same device time again, attributed to their launching op
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    b1_s = sum(e.self_device_time_total for e in events
               if "blake2b" in e.key) / 1e6
    field_s = {name: sum(e.self_device_time_total for e in events
                         if name in e.key) / 1e6
               for name in ("gl_binary_kernel", "xf_binary_kernel",
                            "acc_group_kernel", "acc_powers_kernel",
                            "quotients_kernel")}
    # the copies of torch.cat (CatArrayBatchedCopy kernels)
    cat_s = sum(e.self_device_time_total for e in events
                if "CatArray" in e.key) / 1e6
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_prove.txt"), "w") as fh:
        fh.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    emit("profile", wall_s=wall, device_busy_s=device_s,
         device_busy_share=device_s / wall, b1_device_s=b1_s,
         field_kernels_device_s=field_s, cat_copies_device_s=cat_s,
         top=[{"kernel": e.key[:80], "calls": e.count,
               "device_s": e.self_device_time_total / 1e6}
              for e in events[:12]])


# the work counts and rates of `last_metrics` that the JAX prover reports
RATE_KEYS = ("ntt_butterflies", "ntt_butterflies_per_s", "hash_leaves",
             "hash_leaves_per_s", "extend_rows_per_s")


def rates(bfs):
    return {k: bfs.last_metrics[k] for k in RATE_KEYS}


def reset_counts():
    from stark_brainfuck_tpu_torch.ops import blake2b as B
    from stark_brainfuck_tpu_torch.ops import field_kernels as FK
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as K
    from stark_brainfuck_tpu_torch.ops import quotient_kernels as QK

    B.LAUNCHES = 0
    QK.LAUNCHES_QUOTIENT = 0
    K.LAUNCHES_SUBNTT = 0
    K.LAUNCHES_TWIDDLE = 0
    FK.LAUNCHES_ELEMENTWISE = 0
    FK.LAUNCHES_XFIELD = 0
    FK.LAUNCHES_ACC = 0
    FK.LAUNCHES_ACC_POWERS = 0


def read_counts():
    """Launches of B1, B2, B3 and F1-F4 (and F3's power tables) since the
    last reset_counts()."""
    from stark_brainfuck_tpu_torch.ops import blake2b as B
    from stark_brainfuck_tpu_torch.ops import field_kernels as FK
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as K
    from stark_brainfuck_tpu_torch.ops import quotient_kernels as QK

    return {"b1": B.LAUNCHES, "b2": K.LAUNCHES_SUBNTT,
            "b3": K.LAUNCHES_TWIDDLE, "f1": FK.LAUNCHES_ELEMENTWISE,
            "f2": FK.LAUNCHES_XFIELD, "f3": FK.LAUNCHES_ACC,
            "f3_powers": FK.LAUNCHES_ACC_POWERS,
            "f4": QK.LAUNCHES_QUOTIENT}


def check_f4(counts, evaluations: int, where):
    """F4 launched once a table for each evaluation of the quotients (one a
    resident prove, one a class streamed), and F1-F3 launched."""
    assert counts["f4"] == 5 * evaluations, (where, evaluations, counts)
    assert min(counts[k] for k in ("f1", "f2", "f3")) > 0, (where, counts)


def b_counts(counts):
    """The B1, B2 and B3 launches of a read_counts() dict."""
    return {k: counts[k] for k in ("b1", "b2", "b3")}


# stage_c of the resident prove before F3's redesign (PERF.md; NVIDIA H100
# 80GB HBM3, 700.00 W), for the full-size prove's line to stand beside
STAGE_C = "stage_c (quotients+combination)"
BASELINE_FULL_PROVE = {"f3_launches": 8, "stage_c_s": [0.0427, 0.0574],
                       "peak_bytes_at_stage_c": 4553993728}
# the 2^16-cycle prove before the streamed classes were grouped, one class
# a dispatch (PERF.md, PR 9 call 8; NVIDIA H100 80GB HBM3, 700.00 W):
# {(classes, NTT backend): ...} (1 = resident), the merkle time the sum of
# the base and extension commitments
BASELINE_STREAM = {
    (1, "auto"): {"group": None, "prove_s": 0.5112, "merkle_s": 0.026,
                  "reopen_s": None, "stage_c_s": 0.0857,
                  "max_memory_allocated": 8721072640,
                  "b1": 121, "b2": 0, "b3": 0},
    (32, "auto"): {"group": 1, "prove_s": 2.5802, "merkle_s": 0.364,
                   "reopen_s": 0.408, "stage_c_s": 1.4049,
                   "max_memory_allocated": 1671442432,
                   "b1": 297, "b2": 0, "b3": 0},
    (32, "mxu"): {"group": 1, "prove_s": 1.9687, "merkle_s": 0.256,
                  "reopen_s": 0.233, "stage_c_s": 1.0923,
                  "max_memory_allocated": 1673028608,
                  "b1": 297, "b2": 384, "b3": 192},
    (2, "auto"): {"group": 1, "prove_s": 1.1727, "merkle_s": 0.170,
                  "reopen_s": 0.115, "stage_c_s": 0.2239,
                  "max_memory_allocated": 5088794112,
                  "b1": 125, "b2": 0, "b3": 0},
    (2, "mxu"): {"group": 1, "prove_s": 0.6328, "merkle_s": 0.033,
                 "reopen_s": 0.043, "stage_c_s": 0.1498,
                 "max_memory_allocated": 4343410688,
                 "b1": 125, "b2": 24, "b3": 12},
}
MERKLE_STAGES = ("base merkle (streamed)", "ext merkle (streamed)",
                 "base merkle (device)", "ext merkle (device)")
REOPEN_STAGE = "reopen (streamed 2nd pass)"


def class_transforms(B: int, G: int) -> int:
    """Size-S class transforms of a streamed prove in B classes, G a
    dispatch: B/G in each of the two commit passes and the two reopens
    (base and extension), and 2 a class in the combination, which takes one
    class at a time (as the JAX package's does)."""
    return 4 * B // G + 2 * B


def streamed_b1(resident_b1: int, B: int, G: int) -> int:
    """B1 launches of a streamed prove, from the resident prove's of the
    same claim. A commit pass hashes each group's salts, leaves and log2 G
    pair levels, combines B/G - 1 times in the accumulator and runs a
    ladder log2 B levels shorter than the resident tree's, which hashed its
    salts and leaves once: (B/G)(3 + log2 G) - 3 - log2 B more a pass."""
    log_g, log_b = G.bit_length() - 1, B.bit_length() - 1
    return resident_b1 + 2 * ((B // G) * (3 + log_g) - 3 - log_b)


def stage_c(bfs, counts):
    """A prove's F3 and F4 launches (and F3's power tables'), stage_c
    seconds and peak device bytes at stage_c's mark."""
    m = bfs.last_metrics
    assert counts["f3_powers"] == counts["f3"], counts
    assert m["quotient_launches"] == counts["f4"], (m, counts)
    return {"f3_launches": counts["f3"], "f4_launches": counts["f4"],
            "f3_power_launches": counts["f3_powers"],
            "stage_c_s": m["stages_s"].get(STAGE_C),
            "peak_bytes_at_stage_c": m.get("peak_bytes_at_mark", {}).get(
                STAGE_C)}


def full_proves(src, smi):
    """The full-size prove on the default and the mxu NTT path, and on the
    default path with the quotient stacks op by op on F1/F2
    (`plain_quotients`, the baseline of F4): a warm-up prove and verify for
    each, then two timed proves each, in turns (default, mxu, plain, plain,
    mxu, default) so they are compared on the same card in the same state.
    Launch counts are set to 0 just before each timed prove and read just
    after it; stage times and peak bytes are kept per prove. Every proof
    must equal the default path's warm-up bytes; F4 launches 5 times a
    prove and the plain baseline none, with exactly `quotient_dispatches`
    more F1 and F2 launches. Returns ({path: (stark, args)}, {path: launch
    counts per prove}, the proof)."""
    paths = {"full_prove": {}, "full_prove_mxu": {"ntt_backend": "mxu"},
             "full_prove_plain_quotients": {}}
    starks, warm, runs = {}, {}, {p: [] for p in paths}
    proof = None
    for phase, config in paths.items():
        bfs, args = make_stark(src, 0, "cuda", **config)
        if phase == "full_prove_plain_quotients":
            plain_quotients(bfs)
        t0 = time.time()
        got = bfs.prove(*args)
        warm[phase] = time.time() - t0
        assert bfs.verify(got), f"{phase}: proof failed to verify"
        proof = proof or got
        assert got == proof, f"{phase}: bytes differ from the default path"
        starks[phase] = (bfs, args)
    for phase in ("full_prove", "full_prove_mxu",
                  "full_prove_plain_quotients", "full_prove_plain_quotients",
                  "full_prove_mxu", "full_prove"):
        bfs, args = starks[phase]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        got = bfs.prove(*args)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        assert got == proof, f"{phase}: seeded proves differ"
        assert counts["b1"] > 0, f"{phase}: launched no B1 kernel"
        if phase == "full_prove_plain_quotients":
            f4_run = runs["full_prove"][0]["launches"]
            moved = quotient_dispatches(bfs)
            assert counts == {**f4_run, "f4": 0,
                              "f1": f4_run["f1"] + moved["f1"],
                              "f2": f4_run["f2"] + moved["f2"]}, (
                counts, f4_run, moved)
        else:
            check_f4(counts, 1, phase)
        runs[phase].append({
            "prove_s": wall, "launches": counts, **stage_c(bfs, counts),
            "stages_s": bfs.last_metrics["stages_s"],
            "fri_round_s": bfs.last_metrics["fri_round_s"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "peak_bytes_at_mark": bfs.last_metrics["peak_bytes_at_mark"],
            **rates(bfs),
        })
    for phase, (bfs, args) in starks.items():
        rs = runs[phase]
        cycles = int(args[0].shape[0])
        extra = {}
        if phase == "full_prove_plain_quotients":
            extra = {"quotient_dispatches_replaced": quotient_dispatches(bfs)}
        emit(phase, target_cycles=1 << LOG2_CYCLES, trace_cycles=cycles,
             fri_domain=bfs.fri.domain.length,
             cycles_per_s=cycles / min(r["prove_s"] for r in rs),
             prove_s=[r["prove_s"] for r in rs], warmup_prove_s=warm[phase],
             ntt_path=bfs.last_metrics["ntt_path"], proof_bytes=len(proof),
             verified=True, identical_to_default=True, runs=rs,
             baseline=BASELINE_FULL_PROVE, nvidia_smi=smi, **extra)
    return (starks, {p: [r["launches"] for r in rs] for p, rs in runs.items()},
            proof)


def bytes_across_devices(phase, src, want=None, **config):
    """The same seeded proof on cuda and on cpu; both verify. Returns the
    proof and the cuda prove's launch counts."""
    bfs_gpu, args = make_stark(src, 7, "cuda", **config)
    reset_counts()
    proof_gpu = bfs_gpu.prove(*args)
    counts = read_counts()
    bfs_cpu, _ = make_stark(src, 7, "cpu", **config)
    proof_cpu = bfs_cpu.prove(*args)
    assert bfs_gpu.fri.domain.length >= bfs_gpu.config.device_commit_min
    assert proof_gpu == proof_cpu, f"{phase}: cuda and cpu proofs differ"
    assert want is None or proof_gpu == want, f"{phase}: bytes differ"
    check_f4(counts, 1, phase)
    assert bfs_gpu.verify(proof_gpu) and bfs_cpu.verify(proof_cpu)
    assert counts["b1"] > 0, f"{phase}: device-commit prove launched no B1"
    emit(phase, fri_domain=bfs_gpu.fri.domain.length,
         proof_bytes=len(proof_gpu), identical=True, verified=True,
         identical_to_default=want is not None,
         ntt_path=[bfs_gpu.last_metrics["ntt_path"],
                   bfs_cpu.last_metrics["ntt_path"]],
         launches=counts)
    return proof_gpu, counts


STREAM_SRC = "+" * 8 + "[->++++[-]<]"
STREAM_SMALL = {"stream_min": 1, "stream_classes": 4}


def stream_bytes(want):
    """The N=16384 program down the streamed path (4 classes): cuda and cpu,
    both NTT paths, every proof equal to the resident proof `want`."""
    for backend in ("auto", "mxu"):
        config = {**STREAM_SMALL, "ntt_backend": backend}
        bfs_gpu, args = make_stark(STREAM_SRC, 7, "cuda", **config)
        reset_counts()
        proof_gpu = bfs_gpu.prove(*args)
        counts = read_counts()
        bfs_cpu, _ = make_stark(STREAM_SRC, 7, "cpu", **config)
        proof_cpu = bfs_cpu.prove(*args)
        assert bfs_gpu.use_stream and bfs_cpu.use_stream
        assert proof_gpu == proof_cpu, "stream_bytes: cuda and cpu differ"
        assert proof_gpu == want, "stream_bytes: streamed and resident differ"
        assert bfs_gpu.verify(proof_gpu), bfs_gpu.last_rejection
        # S = 4096 is one sub-transform: a B2 launch and no B3 for each
        # class transform (the 4 classes in one group)
        m = bfs_gpu.last_metrics
        assert m["stream_group"] == 4, m["stream_group"]
        assert counts["b1"] > 0 and (counts["b2"], counts["b3"]) == (
            (class_transforms(4, 4), 0) if backend == "mxu" else (0, 0)
        ), counts
        check_f4(counts, m["stream_classes"], "stream_bytes")
        emit("stream_bytes", ntt_backend=backend,
             fri_domain=bfs_gpu.fri.domain.length,
             classes=m["stream_classes"], block=m["stream_block"],
             group=m["stream_group"],
             ntt_path=[bfs_gpu.last_metrics["ntt_path"],
                       bfs_cpu.last_metrics["ntt_path"]],
             identical=True, identical_to_resident=True, verified=True,
             launches=counts)


def stream_checkpoint(want):
    """Stage checkpoints on the card: the second seeded prove of a claim
    resumes both streamed commit passes and gives the same bytes."""
    with tempfile.TemporaryDirectory() as cdir:
        resumes, launches = [], []
        for _ in range(2):
            bfs, args = make_stark(STREAM_SRC, 7, "cuda", **STREAM_SMALL,
                                   checkpoint_dir=cdir)
            reset_counts()
            proof = bfs.prove(*args)
            launches.append(read_counts()["b1"])
            assert proof == want, "stream_checkpoint: bytes differ"
            resumes.append(list(bfs.last_commit_resumes))
        files = sorted(name.split("_")[-1] for name in os.listdir(cdir))
    assert resumes == [[], ["base", "ext"]], resumes
    assert files == ["base.npz", "ext.npz"], files
    assert launches[1] < launches[0], launches
    emit("stream_checkpoint", resumes=resumes, files=files,
         b1_launches=launches, identical=True)


def stream_kernels():
    """The kernels at the streamed prove's shapes (FRI 2^22 in 32 classes of
    S = 2^17, G = 8 classes a dispatch; 2 classes of 2^21, G = 2). B1
    against its plain version: a group's two leaf widths and its salt PRF
    at G·S messages, one in-group pair level ((G/2)·S pairs read from the
    (G/2, 2, S, 8) digest block), an accumulator combine at S messages, two
    levels of the ladder (`merkle_parents` to 2^16 and to 1,024 parents),
    the 2^22 leaves of a 2-class group, and the 2^22 leaves and 128-byte
    messages of the combination's tree. B2 and B3 against their plain
    versions in the launches of the size-S class transform at a group's
    batch: the column pass, the row pass with its transposed store, and
    the outer twiddle, for G x 19 base and G x 27 extension rows. Then
    `block_values` (one class, as the combination evaluates it) on B2/B3
    against the u64 network, and `group_values` (G classes, as the commit
    passes and the reopen evaluate them) on B2/B3 and on the u64 network
    against G one-class evaluations on the u64 network, for both groups.
    Exact, or it raises."""
    from stark_brainfuck_tpu_torch.ops import blake2b as B
    from stark_brainfuck_tpu_torch.ops import field as f
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as K
    from stark_brainfuck_tpu_torch.protocol import stream

    S = STREAM_S
    N = S * STREAM_CLASSES[0]
    G = stream.group_size_for(STREAM_CLASSES[0], S)
    assert G == 8, G
    b1_cases = [(G * S, 32, 176, "leaf"), (G * S, 32, 240, "leaf"),
                (G * S, 16, 24, "salt"), (G * S // 2, 16, 128, "group pair"),
                (S, 16, 128, "pair"),
                (S // 2, 16, 128, "ladder"), (1024, 16, 128, "ladder"),
                (N, 32, 240, "leaf"), (N, 16, 24, "leaf"),
                (N, 16, 128, "parents")]
    for k, (n, W, msg_len, use) in enumerate(b1_cases):
        words = random_messages(n, W, msg_len, seed=40 + k)
        if use == "pair":
            left, right = words[:, :8].contiguous(), words[:, 8:].contiguous()
            run = lambda: B.merkle_parents_pair(left, right)
        elif use == "group pair":
            # the messages of sibling classes (2t, 2t+1) of a group's digests
            digests = random_messages(2 * n, 8, 64, seed=40 + k)
            pairs = digests.view(-1, 2, S, 8)
            words = torch.cat([pairs[:, 0], pairs[:, 1]], dim=-1).view(n, W)
            run = lambda: B.merkle_parents_pair(
                pairs[:, 0], pairs[:, 1]).view(n, 8)
        elif use == "ladder":
            children = words.reshape(2 * n, 8)
            run = lambda: B.merkle_parents(children)
        else:
            run = lambda: B.blake2b_words(words, msg_len)
        reset_counts()
        got = run()
        assert read_counts()["b1"] == 1, (use, read_counts())
        plain = B.blake2b_words_plain(words, msg_len)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        assert err == 0.0, f"B1 differs from plain torch at {(n, W, msg_len)}"
        bound_ms, bound_by = bound((W * 8 + 64) * n,
                                   n * (W // 16) * OPS_PER_COMPRESSION)
        emit("stream_kernels", kernel="blake2b_words", n=n, W=W,
             msg_len=msg_len, use=use, max_abs_err=err,
             ms=cuda_ms(run, reps=20),
             plain_ms=cuda_ms(
                 lambda: B.blake2b_words_plain(words, msg_len), reps=3),
             bound_ms=bound_ms, bound_by=bound_by)
        del words, got, plain
    omega = f.primitive_nth_root(N)
    plans = {kernel: stream.make_stream_plan(N, STREAM_CLASSES[0], omega,
                                             "cuda", kernel_ntt=kernel)
             for kernel in (False, True)}
    plan = plans[True]["pack_S"]
    assert (plan.n, plan.r, plan.c) == (S, 512, 256), (plan.r, plan.c)
    for stage, rows in NTT_ROWS.items():
        k = G * rows
        x = random_field(k, S, 50 + rows)
        for form, sub, batches, nvec, src, dst in b2_forms(plan, k)[:2]:
            run = lambda: K.subntt_tiled(x, sub, batches, nvec, src, dst)
            run_plain = lambda: K.subntt_tiled_plain(
                x, sub, batches, nvec, src, dst)
            err = max_abs_err(run(), run_plain())
            assert err == 0.0, f"B2 differs from plain torch at {(form, stage)}"
            bound_ms, bound_by = bound(
                16 * k * S + 8 * sub.table.numel(),
                batches * nvec * subntt_ops(sub.m))
            emit("stream_kernels", kernel="subntt", stage=stage, form=form,
                 group=G, rows=batches * nvec, m=sub.m,
                 tile=K.tile_shape(sub.m, True),
                 max_abs_err=err, ms=cuda_ms(run, reps=20),
                 plain_ms=cuda_ms(run_plain, reps=3), bound_ms=bound_ms,
                 bound_by=bound_by)
        y = x.reshape(k * plan.c, plan.r)
        err = max_abs_err(K.twiddle_outer(y, plan),
                          K.twiddle_outer_plain(y, plan))
        assert err == 0.0, f"B3 differs from plain torch at {tuple(y.shape)}"
        bound_ms, bound_by = bound(
            16 * k * S + 8 * (128 + plan.c // 128) * plan.r,
            2 * GL_MUL_OPS * k * S)
        emit("stream_kernels", kernel="twiddle_outer", stage=stage,
             group=G, rows=k * plan.c, r=plan.r, c=plan.c,
             hi_rows=plan.c // 128, max_abs_err=err,
             ms=cuda_ms(lambda: K.twiddle_outer(y, plan), reps=20),
             plain_ms=cuda_ms(lambda: K.twiddle_outer_plain(y, plan), reps=3),
             bound_ms=bound_ms, bound_by=bound_by)
        del x, y
    wbs = f.powers(omega, STREAM_CLASSES[0], "cuda")
    b0 = G  # the second group: classes 8 .. 15
    for stage, rows in NTT_ROWS.items():
        # the prove's groups: 3 randomizer rows of N/4 coefficients, the
        # rest table columns of height + 1 (one randomizer)
        groups = (random_field(3, N // 4, 60 + rows),
                  random_field(rows - 3, (N >> 6) + 1, 61 + rows))
        one = {kernel: (lambda plan=plan: stream.block_values(
            groups, wbs[b0 : b0 + 1], N // 4, plan["pack_S"], S))
            for kernel, plan in plans.items()}
        grouped = {kernel: (lambda plan=plan: stream.group_values(
            groups, wbs[b0 : b0 + G], N // 4, plan["pack_S"], S))
            for kernel, plan in plans.items()}
        per_class = lambda plan: [stream.block_values(
            groups, wbs[b0 + j : b0 + j + 1], N // 4, plan["pack_S"], S)
            for j in range(G)]
        reset_counts()
        got = one[True]()
        counts = read_counts()
        want = one[False]()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        assert err == 0.0, f"block_values on B2/B3 differs at {(rows, S)}"
        assert (counts["b2"], counts["b3"]) == (2, 1), counts
        reset_counts()
        got = grouped[True]()
        counts = read_counts()
        assert (counts["b2"], counts["b3"]) == (2, 1), counts
        want = torch.stack(per_class(plans[False]))
        got_u64 = grouped[False]()
        torch.cuda.synchronize()
        group_err = max(max_abs_err(v.reshape(-1, S), want.reshape(-1, S))
                        for v in (got, got_u64))
        assert group_err == 0.0, (
            f"group_values differs from per-class values at {(G, rows, S)}")
        del got, want, got_u64
        # the class transform alone (B2, B3, B2 against the u64 network):
        # the rest of `block_values` is the scale row and the fold
        folded = random_field(rows, S, 62 + rows)
        emit("stream_kernels", kernel="block_values", stage=stage, rows=rows,
             S=S, r=plan.r, c=plan.c, max_abs_err=err,
             kernel_ms=cuda_ms(one[True], reps=10),
             u64_ms=cuda_ms(one[False], reps=3),
             transform_kernel_ms=cuda_ms(
                 lambda: K.forward_ntt(folded, plan), reps=20),
             transform_u64_ms=cuda_ms(
                 lambda: K.forward_ntt(folded, plans[False]["pack_S"]),
                 reps=3))
        emit("stream_kernels", kernel="group_values", stage=stage, rows=rows,
             S=S, group=G, max_abs_err=group_err,
             kernel_ms=cuda_ms(grouped[True], reps=10),
             per_class_kernel_ms=cuda_ms(
                 lambda: per_class(plans[True]), reps=5),
             u64_ms=cuda_ms(grouped[False], reps=3),
             per_class_u64_ms=cuda_ms(
                 lambda: per_class(plans[False]), reps=3))
        del groups, folded


def stream_plans(classes, backends=("auto", "mxu")):
    """(kind, config) of a streamed prove for each class count and NTT
    backend."""
    return [("streamed", {"stream_classes": B, "ntt_backend": nb})
            for B in classes for nb in backends]


def stream_proves(log2_cycles, smi, plans):
    """A counter of 2^log2_cycles cycles proved once for each (kind, config)
    of `plans`: "streamed", "resident" (the same claim with `stream_min`
    raised past its domain), or "streamed_plain_quotients" (streamed, the
    quotient stacks op by op on F1/F2: F4's baseline, held to exactly
    `quotient_dispatches` more F1/F2 launches than the first streamed prove
    of its classes and backend, and no F4).
    Each with the launch counts set to 0 just before it and read just
    after, stage times and peak bytes. All proofs must be equal and the
    first must verify. A streamed prove launches B2 and B3 twice and once
    for each class transform on the mxu path (none on the default one) and,
    after a resident prove of the claim, exactly `streamed_b1` B1 kernels.
    Returns the runs."""
    from stark_brainfuck_tpu_torch import VirtualMachine
    from stark_brainfuck_tpu_torch.protocol import stream

    src = counter_program(1 << log2_cycles)
    trace = VirtualMachine.simulate(VirtualMachine.compile(src))
    cycles = int(trace["processor"].shape[0])
    proof, runs, resident_b1 = None, [], None
    for kind, config in plans:
        if kind == "resident":
            config = {**config, "stream_min": 1 << (log2_cycles + 7)}
        bfs, args = make_stark(src, 0, "cuda", trace=trace, **config)
        if kind == "streamed_plain_quotients":
            plain_quotients(bfs)
        assert bfs.use_stream == (kind != "resident"), (kind, config)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        got = bfs.prove(*args)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        if proof is None:
            proof = got
            assert bfs.verify(got), f"stream_prove: {bfs.last_rejection}"
        assert got == proof, f"stream_prove: bytes differ at {(kind, config)}"
        m = bfs.last_metrics
        backend = config.get("ntt_backend", "auto")
        B, S, G = m["stream_classes"], m["stream_block"], m["stream_group"]
        if kind == "streamed_plain_quotients":
            f4_run = next(r["launches"] for r in runs
                          if r["kind"] == "streamed" and r["classes"] == B
                          and r["ntt_backend"] == backend)
            moved = quotient_dispatches(bfs, B)
            assert counts == {**f4_run, "f4": 0,
                              "f1": f4_run["f1"] + moved["f1"],
                              "f2": f4_run["f2"] + moved["f2"]}, (
                counts, f4_run, moved)
        else:
            check_f4(counts, B if kind == "streamed" else 1,
                     ("stream_prove", kind, config))
        if kind != "resident":
            assert G == stream.group_size_for(B, S), (B, S, G)
            # each class transform is 2 B2 and 1 B3 launches on mxu
            transforms = class_transforms(B, G) if backend == "mxu" else 0
            assert (counts["b2"], counts["b3"]) == (
                2 * transforms, transforms), (B, G, counts)
            if resident_b1 is not None:
                assert counts["b1"] == streamed_b1(resident_b1, B, G), (
                    B, G, resident_b1, counts)
        else:
            assert (counts["b2"], counts["b3"]) == (0, 0), counts
            resident_b1 = counts["b1"]
        stages = m["stages_s"]
        run = {"kind": kind, "ntt_backend": backend,
               "ntt_path": m["ntt_path"], "classes": B, "block": S,
               "group": G, "trace_cycles": cycles,
               "fri_domain": m["fri_domain"], "prove_s": wall,
               "cycles_per_s": cycles / wall, "launches": counts,
               "merkle_s": sum(stages.get(k, 0.0) for k in MERKLE_STAGES),
               "reopen_s": stages.get(REOPEN_STAGE),
               "stages_s": stages, **stage_c(bfs, counts),
               "baseline_ungrouped": BASELINE_STREAM.get(
                   (B if kind != "resident" else 1, backend))
               if log2_cycles == STREAM_LOG2_CYCLES else None,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "peak_bytes_at_mark": m["peak_bytes_at_mark"], **rates(bfs),
               "proof_bytes": len(got), "identical": True,
               "verified": True, "nvidia_smi": smi}
        emit("stream_prove", **run)
        runs.append(run)
        del bfs, args, got
    return runs


# ---------------------------------------------------------------------------
# the reference codec, the DEBUG degree checks, other soundness parameters
# ---------------------------------------------------------------------------

GOLDEN_REF_PROOF = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "vectors",
    "ref_proof_plus4.bin")
REF_PROVE_LOG2_CYCLES = 10  # FRI 2^16 under the reference codec
# the most the FRI last codeword (2 x expansion values) allows at expansion
# 16: 32 colinearity checks; security level 160 needs expansion 32
SOUNDNESS = {"security_level": 128, "log_expansion_factor": 4}
SOUNDNESS_SRC = "++++[->++<]"  # FRI 2^14 at SOUNDNESS
SOUNDNESS_LOG2_CYCLES = 13  # FRI 2^21 at SOUNDNESS, resident


def timed_prove(bfs, args):
    """One prove on the card with the launch counts set to 0 just before
    it and read just after. Returns (proof, seconds, counts)."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    proof = bfs.prove(*args)
    torch.cuda.synchronize()
    return proof, time.time() - t0, read_counts()


def ref_codec_bytes(native_proof):
    """The N=16384 program under `codec="ref"`: the same bytes on cuda on
    both NTT paths and on cpu (one prove: the bytes do not depend on the
    path); every proof verifies; the card ran B1 for the salt and
    randomizer PRFs (the trees are hashlib host trees over pickled leaves)
    and B2/B3 under mxu; the bytes differ from the native proof. Returns
    the launches of B1 on the default path's prove and of B2/B3 on the mxu
    path's."""
    proof, launches = None, {}
    for backend in ("auto", "mxu"):
        bfs, args = make_stark(STREAM_SRC, 7, "cuda", codec="ref",
                               ntt_backend=backend)
        got, wall, counts = timed_prove(bfs, args)
        proof = proof or got
        launches.update(
            {k: counts[k] for k in ("b1", "f1", "f2", "f3", "f4")}
            if backend == "auto" else {"b2": counts["b2"], "b3": counts["b3"]})
        assert got == proof, "ref_codec_bytes: the NTT paths differ"
        assert got != native_proof, "ref_codec_bytes: equals the native proof"
        assert bfs.verify(got), bfs.last_rejection
        assert counts["b1"] > 0, counts
        check_f4(counts, 1, "ref_codec_bytes")
        assert (min(counts["b2"], counts["b3"]) > 0) == (backend == "mxu")
        emit("ref_codec_bytes", device="cuda", ntt_backend=backend,
             fri_domain=bfs.fri.domain.length, proof_bytes=len(got),
             prove_s=wall, launches=counts, verified=True,
             ntt_path=bfs.last_metrics["ntt_path"],
             hash_path=bfs.last_metrics["hash_path"],
             stages_s=bfs.last_metrics["stages_s"])
    bfs, args = make_stark(STREAM_SRC, 7, "cpu", codec="ref")
    t0 = time.time()
    got = bfs.prove(*args)
    wall = time.time() - t0
    assert got == proof, "ref_codec_bytes: cuda and cpu proofs differ"
    assert bfs.verify(got), bfs.last_rejection
    emit("ref_codec_bytes", device="cpu", fri_domain=bfs.fri.domain.length,
         proof_bytes=len(got), prove_s=wall, identical=True, verified=True)
    return launches


def ref_codec_golden():
    """A stark on the card accepts the reference prover's proof of `++++`
    and rejects it with one terminal changed."""
    import pickle

    from stark_brainfuck_tpu_torch.interop.ref_shims import ensure_ref_modules

    golden = open(GOLDEN_REF_PROOF, "rb").read()
    bfs, _ = make_stark("++++", 0, "cuda", codec="ref")
    t0 = time.time()
    assert bfs.verify(golden), bfs.last_rejection
    wall = time.time() - t0
    ensure_ref_modules()
    objects = pickle.loads(golden)
    coeff = objects[2].polynomial.coefficients[0]
    coeff.value = (coeff.value + 1) % 0xFFFFFFFF00000001
    assert not bfs.verify(pickle.dumps(objects)), "tampered golden accepted"
    emit("ref_codec_golden", proof_bytes=len(golden),
         fri_domain=bfs.fri.domain.length, verify_s=wall, accepted=True,
         tampered_rejected=True, rejection=bfs.last_rejection)


def ref_codec_prove(smi):
    """A counter of about 2^10 cycles (FRI 2^16) under the reference codec:
    one timed prove and its verify, with the stage times (the host's share
    is the pickling and hashing of the three trees and FRI's rounds)."""
    src = counter_program(1 << REF_PROVE_LOG2_CYCLES)
    bfs, args = make_stark(src, 0, "cuda", codec="ref")
    proof, wall, counts = timed_prove(bfs, args)
    t0 = time.time()
    assert bfs.verify(proof), bfs.last_rejection
    verify_s = time.time() - t0
    assert counts["b1"] > 0, counts
    check_f4(counts, 1, "ref_codec_prove")
    m = bfs.last_metrics
    emit("ref_codec_prove", trace_cycles=int(args[0].shape[0]),
         fri_domain=m["fri_domain"], proof_bytes=len(proof), prove_s=wall,
         verify_s=verify_s, launches=counts, stages_s=m["stages_s"],
         fri_round_s=m["fri_round_s"], hash_path=m["hash_path"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         verified=True, nvidia_smi=smi)
    return counts


def debug_degrees(native_proof):
    """The N=16384 program with `debug_degree_checks=True` on the card:
    every quotient interpolated on the host and its degree checked; the
    bytes equal those of the prove with the checks off."""
    bfs, args = make_stark(STREAM_SRC, 7, "cuda", debug_degree_checks=True)
    proof, wall, counts = timed_prove(bfs, args)
    assert proof == native_proof, "debug_degrees: bytes differ"
    check_f4(counts, 1, "debug_degrees")
    emit("debug_degrees", fri_domain=bfs.fri.domain.length,
         proof_bytes=len(proof), prove_s=wall, launches=counts,
         identical_to_unchecked=True)


def poly_toolbox():
    """`ops/fastpoly.py` on the card against the CPU and `ops/poly.py` (the
    DEBUG checks' and the JAX package's tests' toolbox; exact): the
    interpolant of 1,000 seeded points, evaluated back at them, and a
    coset division that undoes a product."""
    import numpy as np

    from stark_brainfuck_tpu_torch.convert import tensor_to_u64
    from stark_brainfuck_tpu_torch.ops import fastpoly as fp
    from stark_brainfuck_tpu_torch.ops import field as F
    from stark_brainfuck_tpu_torch.ops import poly as hp

    rng = np.random.default_rng(11)
    n = 1000
    pts = np.unique(rng.integers(0, F.P, size=(n,), dtype=np.uint64))
    vals = rng.integers(0, F.P, size=pts.shape, dtype=np.uint64)
    q = rng.integers(0, F.P, size=(300,), dtype=np.uint64)
    b = rng.integers(0, F.P, size=(40,), dtype=np.uint64)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.time()
        interp = fp.fast_interpolate(pts, vals, device=device)
        back = fp.fast_evaluate(interp, pts)
        a = fp.fast_multiply(q, b, device=device)
        div = fp.fast_coset_divide(a, b, F.GENERATOR,
                                   F.primitive_nth_root(1024), 1024,
                                   device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        out[device] = ([tensor_to_u64(x).tolist() for x in (interp, back, div)],
                       time.time() - t0)
    (interp, back, div), _ = out["cuda"]
    assert out["cuda"][0] == out["cpu"][0], "poly_toolbox: cuda and cpu differ"
    assert back == vals.tolist(), "poly_toolbox: interpolant misses a point"
    assert div[: len(q)] == q.tolist(), "poly_toolbox: division is not exact"
    some = [int(x) for x in pts[:3]]
    assert [hp.evaluate(interp, x) for x in some] == vals[:3].tolist()
    emit("poly_toolbox", points=int(pts.shape[0]), identical=True,
         seconds={k: v[1] for k, v in out.items()})


def soundness_params(smi):
    """Security level 128 at expansion 16 (32 colinearity checks, 128
    query indices). A FRI-2^14 program: cuda equals cpu on both NTT paths.
    Then a counter of 2^13 cycles (FRI 2^21, resident): one timed prove on
    each NTT path, the same bytes, verified."""
    proof = None
    for device, backend in (("cuda", "auto"), ("cuda", "mxu"),
                            ("cpu", "auto"), ("cpu", "mxu")):
        bfs, args = make_stark(SOUNDNESS_SRC, 7, device, ntt_backend=backend,
                               **SOUNDNESS)
        got = bfs.prove(*args)
        proof = proof or got
        assert got == proof, f"soundness_params: {device} {backend} differ"
    assert bfs.verify(proof), bfs.last_rejection
    emit("soundness_params", program=SOUNDNESS_SRC, **SOUNDNESS,
         colinearity_checks=bfs.fri.num_colinearity_tests,
         fri_domain=bfs.fri.domain.length, proof_bytes=len(proof),
         identical=True, verified=True)
    src = counter_program(1 << SOUNDNESS_LOG2_CYCLES)
    proof = None
    for backend in ("auto", "mxu"):
        bfs, args = make_stark(src, 0, "cuda", ntt_backend=backend,
                               **SOUNDNESS)
        assert not bfs.use_stream
        got, wall, counts = timed_prove(bfs, args)
        proof = proof or got
        assert got == proof, "soundness_params: the NTT paths differ"
        t0 = time.time()
        assert bfs.verify(got), bfs.last_rejection
        verify_s = time.time() - t0
        assert counts["b1"] > 0, counts
        check_f4(counts, 1, "soundness_params")
        m = bfs.last_metrics
        cycles = int(args[0].shape[0])
        emit("soundness_params", **SOUNDNESS, ntt_backend=backend,
             ntt_path=m["ntt_path"], trace_cycles=cycles,
             fri_domain=m["fri_domain"], prove_s=wall,
             cycles_per_s=cycles / wall, verify_s=verify_s,
             proof_bytes=len(got), launches=counts, stages_s=m["stages_s"],
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             identical=True, verified=True, nvidia_smi=smi)
        del bfs, args


# ---------------------------------------------------------------------------
# the sharded prover: what a rank (a worker process on the card) runs
# ---------------------------------------------------------------------------

MESH_DNTT_ROWS = NTT_ROWS["ext"]


def rank_dntt(mesh, payload):
    """`distributed_ntt_with` of (27, 2^21) seeded rows on both local
    routes, each against the rank's block of the single-device u64
    network; with the time of the torch copies left around the local DFTs
    (the load of the rank's columns, and the packing and joining around the
    two all-to-alls, from the mesh's own stats)."""
    from stark_brainfuck_tpu_torch.ops import field as f
    from stark_brainfuck_tpu_torch.ops import ntt as nt
    from stark_brainfuck_tpu_torch.parallel import dntt

    n = 1 << LOG2_FRI
    root = f.primitive_nth_root(n)
    v = random_field(MESH_DNTT_ROWS, n, 77)
    lo, hi = mesh.block(n)
    want = nt.ntt_with(v, nt.make_pack(n, root, False, "cuda"))
    want = want[:, lo:hi].contiguous()
    out = {}
    for route in ("u64", "kernel"):
        tables = dntt.make_dntt_tables(n, root, mesh, kernel=route == "kernel")
        torch.cuda.synchronize()
        reset_counts()
        mesh.reset_stats()
        t0 = time.time()
        got = dntt.distributed_ntt_with(v, tables, mesh)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        c_lo, c_hi = mesh.block(tables.C)
        out[route] = {
            "max_abs_err": max_abs_err(got, want), "seconds": seconds,
            "launches": read_counts(), "block": list(got.shape),
            "factors": [tables.R, tables.C],
            "twiddle_on_b3": tables.twiddle_plan is not None,
            **mesh.stats_report(),
            "local_columns_ms": cuda_ms(lambda: dntt._local_columns(
                [v], tables.R, tables.C, c_lo, c_hi - c_lo), reps=5),
        }
        del got, tables
    return out


def rank_kernels(mesh, payload):
    """The kernels at the shapes and in the forms that this rank's share of
    the full-width mesh prove gives them, each against its plain version on
    the same card tensors, exactly. B2: both local DFTs of the distributed
    transform (`dntt._dft_middle`: the R-point one with its transposed
    store, the C-point one in place of layout) for the 19 base and the 27
    extension rows, against `subntt_tiled_plain` under the same strides and
    against the u64 network. B3: the twiddle step with this rank's tables
    (its column offset in the hi factor) against `twiddle_outer_plain` and
    against the field multiply by the rank's plain table. B1: the block's
    leaves, salts and tree levels against `blake2b_words_plain`. F4: each
    table's quotients of a mesh stark of payload["src"] on seeded columns
    of the rank's block, through the sharded branch of
    `_table_quotient_stack` (the next row rolled across the ranks by
    `mesh.roll`, then F4 with rot 0) against `_table_quotient_stack_plain`
    (the same roll, then F1/F2). Times are not taken: the ranks share the
    card."""
    from stark_brainfuck_tpu_torch.ops import blake2b as B
    from stark_brainfuck_tpu_torch.ops import field as f
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as K
    from stark_brainfuck_tpu_torch.parallel import dntt
    from stark_brainfuck_tpu_torch.protocol import device_merkle as dm

    n = 1 << LOG2_FRI
    D = mesh.world
    root = f.primitive_nth_root(n)
    kern = dntt.make_dntt_tables(n, root, mesh, kernel=True)
    u64 = dntt.make_dntt_tables(n, root, mesh)
    assert kern.twiddle_plan is not None and u64.twiddle is not None
    R, C = kern.R, kern.C
    cl, rd = C // D, R // D
    out = {"rank": mesh.rank, "factors": [R, C], "cases": []}

    def case(kernel, want, **at):
        got = b_counts(read_counts())
        assert got == {"b1": 0, "b2": 0, "b3": 0, **want}, (kernel, at, got)
        out["cases"].append({"kernel": kernel, **at, "max_abs_err": 0.0})

    for stage, rows in NTT_ROWS.items():
        for dft, m, v, pack_k, pack_u, transposed in (
                ("rows", R, cl, kern.pack_r, u64.pack_r, True),
                ("columns", C, rd, kern.pack_c, u64.pack_c, False)):
            x = random_field(rows * m, v, 80 + rows + m).view(rows, m, v)
            reset_counts()
            got = dntt._dft_middle(x, pack_k, transposed)
            src = K.Strides(m * v, 1, v)
            dst = K.Strides(m * v, m, 1) if transposed else src
            plain = K.subntt_tiled_plain(x, pack_k.sub_r, rows, v, src, dst)
            assert torch.equal(got.reshape(-1), plain.reshape(-1)), (
                f"B2 differs from plain torch at the {dft} DFT ({stage})")
            assert torch.equal(got, dntt._dft_middle(x, pack_u, transposed)), (
                f"B2 differs from the u64 network at the {dft} DFT ({stage})")
            case("subntt", {"b2": 1}, stage=stage, dft=dft,
                 vectors=rows * v, m=m, transposed_store=transposed,
                 tile=K.tile_shape(m, True))
            del x, got, plain
        y = random_field(rows * cl, R, 90 + rows)
        reset_counts()
        got = K.twiddle_outer(y, kern.twiddle_plan)
        assert torch.equal(got, K.twiddle_outer_plain(y, kern.twiddle_plan)), (
            f"B3 differs from plain torch at rank {mesh.rank} ({stage})")
        assert torch.equal(
            got.view(rows, cl, R),
            f.mul(y.view(rows, cl, R), u64.twiddle[None])), (
            f"B3's offset tables differ from the rank's twiddle columns "
            f"at rank {mesh.rank} ({stage})")
        case("twiddle_outer", {"b3": 1}, stage=stage,
             rows=rows * cl, r=R, c=cl, column_offset=mesh.rank * cl,
             hi_rows=int(kern.twiddle_plan.tw_hi.shape[0]))
        del y, got
    # the block's hashes: both leaf widths and the salt PRF at N/D leaves, a
    # FRI round's leaves at half of that and at the smallest block, and the
    # tree's levels from N/(2D) parents down to the rank's share of the top
    nb = n // D
    b1_cases = [(nb, 32, 176, "leaf"), (nb, 32, 240, "leaf"),
                (nb, 16, 24, "salt"), (nb // 2, 16, 24, "leaf"),
                (128, 16, 24, "leaf"), (nb // 2, 16, 128, "parents"),
                (dm._HOST_CUT // D, 16, 128, "parents")]
    for k, (count, W, msg_len, use) in enumerate(b1_cases):
        words = random_messages(count, W, msg_len, seed=70 + k)
        reset_counts()
        if use == "parents":
            got = B.merkle_parents(words.reshape(2 * count, 8))
        else:
            got = B.blake2b_words(words, msg_len)
        plain = B.blake2b_words_plain(words, msg_len)
        assert torch.equal(got, plain), (
            f"B1 differs from plain torch at {(count, W, msg_len)}")
        case("blake2b_words", {"b1": 1}, n=count, W=W,
             msg_len=msg_len, use=use)
        del words, got, plain
    bfs, _ = make_stark(payload["src"], 0, "cuda",
                        mesh_shape=(("shard", D),))
    N = bfs.fri.domain.length
    _, nb = bfs._block()
    ch = random_field(1, 33, 60)[0].view(11, 3)
    tm = random_field(1, 15, 61)[0].view(5, 3)
    for ti, t in enumerate(bfs.tables):
        base = random_field(t.base_width, nb, 62 + ti)
        ext = random_field(3 * t.num_ext_columns, nb, 67 + ti).view(
            t.num_ext_columns, 3, nb).movedim(1, -1)
        zinv = {k: random_field(1, nb, 72 + 3 * ti + j)[0]
                for j, k in enumerate(("boundary", "transition", "terminal"))}
        reset_counts()
        got = bfs._table_quotient_stack(ti, base, ext, ch, tm, zinv)
        counts = read_counts()
        assert counts == {**{k: 0 for k in counts}, "f4": 1}, (t.name, counts)
        want = bfs._table_quotient_stack_plain(ti, base, ext, ch, tm, zinv)
        assert torch.equal(got, want), (
            f"F4 differs from the plain stack at rank {mesh.rank} ({t.name})")
        out["cases"].append({"kernel": "quotients", "table": t.name, "n": nb,
                             "rolled_across_ranks": t.unit_distance(N) > 0,
                             "max_abs_err": 0.0})
        del base, ext, got, want
    torch.cuda.synchronize()
    return out


def rank_proves(mesh, payload):
    """Seeded proves of payload["src"] over the mesh of all ranks, one for
    each NTT backend (after `warmups` untimed ones), on the rank's device."""
    from stark_brainfuck_tpu_torch.parallel.multihost import env_device

    out = {}
    for backend in ("auto", "mxu"):
        bfs, args = make_stark(
            payload["src"], payload["seed"], env_device(),
            trace=payload.get("trace"), ntt_backend=backend,
            mesh_shape=(("shard", mesh.world),))
        cuda = bfs.device.type == "cuda"
        for _ in range(payload.get("warmups", 0)):
            bfs.prove(*args)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        proof = bfs.prove(*args)
        if cuda:
            torch.cuda.synchronize()
        wall = time.time() - t0
        m = bfs.last_metrics
        out[backend] = {
            "digest": hashlib.sha256(proof).hexdigest(),
            "proof": proof if mesh.rank == 0 and payload.get("keep") else None,
            "prove_s": wall, "launches": read_counts(),
            "ntt_path": m["ntt_path"], "hash_path": m["hash_path"],
            "mesh": m["mesh"], "stages_s": m["stages_s"],
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if cuda else None),
            "peak_bytes_at_mark": m.get("peak_bytes_at_mark"),
        }
        del bfs
    return out


def spawn_on(device, target, world, payload, timeout=600):
    from stark_brainfuck_tpu_torch.parallel.multihost import spawn_ranks

    torch.cuda.empty_cache()
    return spawn_ranks(
        f"chip_smoke:{target}", world, payload, device=device,
        timeout=timeout,
        python_path=[os.path.dirname(os.path.abspath(__file__))])


def dntt_check():
    for world in (2, 4):
        ranks = spawn_on("cuda", "rank_dntt", world, None)
        for route in ("u64", "kernel"):
            rs = [r[route] for r in ranks]
            want = {"b1": 0, "b2": 2, "b3": 1} if route == "kernel" else {
                "b1": 0, "b2": 0, "b3": 0}
            for rank, r in enumerate(rs):
                assert r["max_abs_err"] == 0.0, (
                    f"dntt_check: rank {rank} of {world} differs ({route})")
                assert b_counts(r["launches"]) == want, (world, route,
                                                         rank, r)
                assert r["block"] == [MESH_DNTT_ROWS, (1 << LOG2_FRI) // world]
            emit("dntt_check", world=world, route=route,
                 rows=MESH_DNTT_ROWS, n=1 << LOG2_FRI, max_abs_err=0.0,
                 factors=rs[0]["factors"], twiddle_on_b3=rs[0]["twiddle_on_b3"],
                 launches_per_rank=[r["launches"] for r in rs],
                 seconds_per_rank=[r["seconds"] for r in rs],
                 collective_s_per_rank=[r["collective_s"] for r in rs],
                 collective_copy_s_per_rank=[r["collective_copy_s"]
                                             for r in rs],
                 local_columns_ms_per_rank=[r["local_columns_ms"]
                                            for r in rs],
                 collective_bytes_per_rank=[r["collective_bytes"] for r in rs])


def mesh_kernels(src, world=2):
    """B1, B2, B3 and F4 on every rank of a `world`-rank mesh at the shapes
    of the full-width mesh prove of `src` (`rank_kernels`): any difference
    raises in the rank and fails the run."""
    ranks = spawn_on("cuda", "rank_kernels", world, {"src": src})
    assert [r["rank"] for r in ranks] == list(range(world))
    for r in ranks:
        names = {c["kernel"] for c in r["cases"]}
        assert names == {"blake2b_words", "subntt", "twiddle_outer",
                         "quotients"}, names
        for c in r["cases"]:
            emit("mesh_kernels", world=world, rank=r["rank"],
                 factors=r["factors"], **c)


def mesh_bytes(src, want: bytes):
    """The N=16384 program over 2 and 4 ranks, on the card and on the CPU,
    default and mxu: every rank's bytes equal the single-device proof."""
    digest = hashlib.sha256(want).hexdigest()
    verified = False
    for device in ("cuda", "cpu"):
        for world in (2, 4):
            ranks = spawn_on(device, "rank_proves", world,
                             {"src": src, "seed": 7, "keep": not verified})
            for backend in ("auto", "mxu"):
                rs = [r[backend] for r in ranks]
                for rank, r in enumerate(rs):
                    assert r["digest"] == digest, (
                        f"mesh_bytes: rank {rank} of {world} on {device} "
                        f"({backend}) differs from the single-device proof")
                    assert r["mesh"]["sharded_commit"], r["mesh"]
                    if device == "cuda":
                        assert r["launches"]["b1"] > 0, (world, rank, r)
                        assert (r["launches"]["b2"] > 0) == (backend == "mxu")
                        check_f4(r["launches"], 1, ("mesh_bytes", world, rank))
                if not verified:
                    bfs, _ = make_stark(src, 7, "cpu")
                    assert rs[0]["proof"] == want
                    assert bfs.verify(rs[0]["proof"]), bfs.last_rejection
                    verified = True
                emit("mesh_bytes", device=device, world=world,
                     ntt_backend=backend, ntt_path=rs[0]["ntt_path"],
                     hash_path=rs[0]["hash_path"],
                     backend=rs[0]["mesh"]["backend"],
                     devices=rs[0]["mesh"]["devices"], identical=True,
                     verified=True, prove_s_per_rank=[r["prove_s"] for r in rs],
                     launches_per_rank=[r["launches"] for r in rs])


def mesh_prove(src, want: bytes, smi, world=2):
    """The full-width resident prove (FRI 2^21) on `world` ranks (sharing
    the card where there is one), default and mxu: a warm-up and a timed
    prove each. Returns each rank's launch counts, {backend: [counts of
    rank 0, rank 1, ...]}."""
    from stark_brainfuck_tpu_torch import VirtualMachine

    trace = VirtualMachine.simulate(VirtualMachine.compile(src))
    ranks = spawn_on("cuda", "rank_proves", world,
                     {"src": src, "seed": 0, "trace": trace, "warmups": 1},
                     timeout=900)
    digest = hashlib.sha256(want).hexdigest()
    launches = {}
    for backend in ("auto", "mxu"):
        rs = [r[backend] for r in ranks]
        for rank, r in enumerate(rs):
            assert r["digest"] == digest, (
                f"mesh_prove: rank {rank} ({backend}) differs from full_prove")
            c = r["launches"]
            assert c["b1"] > 0, f"mesh_prove: rank {rank} launched no B1"
            check_f4(c, 1, ("mesh_prove", backend, rank))
            assert (c["b2"], c["b3"]) == (
                (4, 2) if backend == "mxu" else (0, 0)), (backend, rank, c)
        launches[backend] = [r["launches"] for r in rs]
        emit("mesh_prove", world=world, ntt_backend=backend,
             ntt_path=rs[0]["ntt_path"], fri_domain=1 << LOG2_FRI,
             trace_cycles=int(trace["processor"].shape[0]),
             backend=rs[0]["mesh"]["backend"], devices=rs[0]["mesh"]["devices"],
             identical_to_full_prove=True,
             prove_s_per_rank=[r["prove_s"] for r in rs],
             launches_per_rank=launches[backend],
             collectives_per_rank=[r["mesh"]["collectives"] for r in rs],
             collective_s_per_rank=[r["mesh"]["collective_s"] for r in rs],
             collective_bytes_per_rank=[r["mesh"]["collective_bytes"]
                                        for r in rs],
             max_memory_allocated_per_rank=[r["max_memory_allocated"]
                                            for r in rs],
             stages_s_per_rank=[r["stages_s"] for r in rs],
             peak_bytes_at_mark_per_rank=[r["peak_bytes_at_mark"] for r in rs],
             nvidia_smi=smi)
    return launches


def kernel_entry(name, source, replaces, launches, launches_streamed,
                 launches_mesh, launches_ref, rows, main, at, no_library,
                 replaces_note=None, extra=None):
    """One row of the kernels line: ms, plain_ms and bound at the main
    shape `rows[main]`, the largest error over every checked shape;
    `launches` of the resident full-size prove, `launches_streamed` of the
    streamed one (32 classes), `launches_mesh` of one rank of the 2-rank
    mesh prove and `launches_ref` of the ref-codec prove at FRI 2^14 (B2
    and B3: on the mxu path); `no_library` says why library_ms is null."""
    main_shape = rows[main]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        **({"replaces_note": replaces_note} if replaces_note else {}),
        "launches": launches,
        "launches_streamed": launches_streamed,
        "launches_mesh_per_rank": launches_mesh,
        "launches_ref_codec": launches_ref,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "library_ms_null_because": no_library,
        "at": {k: main_shape[k] for k in at},
        **(extra or {}),
    }


def other_paths(native_proof, smi):
    """Step 8: the reference codec, the DEBUG degree checks, the polynomial
    toolbox and the non-default soundness parameters, on the kernels of the
    main path. Returns the launches of `ref_codec_bytes`' proves."""
    launches = ref_codec_bytes(native_proof)
    ref_codec_golden()
    ref_codec_prove(smi)
    debug_degrees(native_proof)
    poly_toolbox()
    soundness_params(smi)
    return launches


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace one full-size prove with torch.profiler "
                         "and write its kernel table to DIR")
    ap.add_argument("--b2-sweep", action="store_true",
                    help="after the build, time kernel B2 under several "
                         "tile shapes and stop")
    ap.add_argument("--b2-parts", action="store_true",
                    help="after the build, time kernel B2 with its arithmetic "
                         "or its memory traffic cut out, and stop")
    ap.add_argument("--stream-log2-cycles", type=int, metavar="K",
                    help="after the build, prove a counter of 2^K cycles down "
                         "the streamed path (32 classes, both NTT paths), "
                         "and stop")
    ap.add_argument("--field-kernels", action="store_true",
                    help="after the build, run the field_kernels phase "
                         "(F1, F2, F3 against their plain versions) and stop")
    ap.add_argument("--ref-codec", action="store_true",
                    help="after the build, run step 5 and the phases of the "
                         "reference codec, the DEBUG degree checks and the "
                         "other soundness parameters, and stop")
    ap.add_argument("--mesh", type=int, nargs="?", const=2, metavar="RANKS",
                    help="leave out the single-device kernel checks and the "
                         "streamed prover, run mesh_prove on RANKS ranks "
                         "(2), and stop before the kernels line")
    opts = ap.parse_args()
    if opts.stream_log2_cycles and not 16 <= opts.stream_log2_cycles <= 20:
        ap.error("--stream-log2-cycles takes 16..20: FRI 2^22 (the default "
                 "stream_min) to 2^26 (the largest domain)")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from stark_brainfuck_tpu_torch.ops import cuda_build

    # 1. device
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build every kernel source, in parallel, then the host runtime
    t0 = time.time()
    libs = cuda_build.build()
    host_libs = cuda_build.build_host()
    build_s = time.time() - t0
    ptxas = {}
    for name, lib in libs.items():
        log = lib[:-3] + ".log"
        if os.path.exists(log):
            with open(log) as fh:
                ptxas[name] = [ln.strip() for ln in fh
                               if "Used" in ln or "spill" in ln]
    emit("build", kernels={k: os.path.relpath(v) for k, v in libs.items()},
         host={k: os.path.relpath(v) for k, v in host_libs.items()},
         seconds=build_s, ptxas=ptxas,
         sass_instructions={k: sass_counts(v) for k, v in libs.items()})
    assert {"blake2b", "ntt", "field", "quotients"} <= set(libs), libs
    assert {"hashing", "vm", "quotients_host"} <= set(host_libs), host_libs

    full_src = counter_program(1 << LOG2_CYCLES)
    if opts.field_kernels:
        field_kernels()
        quotient_kernel(full_src, smi)
        print(smi, flush=True)
        return
    if opts.b2_sweep or opts.b2_parts or opts.stream_log2_cycles:
        if opts.b2_sweep:
            b2_sweep()
        if opts.b2_parts:
            b2_parts()
        if opts.stream_log2_cycles:
            stream_proves(opts.stream_log2_cycles, smi,
                          stream_plans(STREAM_CLASSES[:1]))
        print(smi, flush=True)
        return
    native_host(smi)
    if not (opts.mesh or opts.ref_codec):
        # 3. B1 against its plain version and hashlib at the prover's shapes
        b1 = check_b1()

        # 4. B2 / B3 against their plain versions; the composed transform
        # against the u64 network
        check_b2_every_size()
        b2, b3 = check_ntt_kernels()

        # 4b. F1, F2, F3 against their plain versions; F4 against the
        # op-by-op quotient stack
        f_rows = field_kernels()
        f_rows["f4"] = quotient_kernel(full_src, smi)

    # 5. the same seeded proof on cuda and on cpu, default and mxu NTT
    src = STREAM_SRC
    proof_small, _ = bytes_across_devices("bytes_across_devices", src)
    _, counts = bytes_across_devices(
        "bytes_across_devices_mxu", src, want=proof_small, ntt_backend="mxu"
    )
    assert counts["b2"] > 0 and counts["b3"] > 0, (
        "mxu prove launched no B2/B3 kernel"
    )
    if opts.ref_codec:
        other_paths(proof_small, smi)
        print(smi, flush=True)
        return

    # 6. full-size prove on the card, default and mxu NTT in turns
    starks, launches, proof_full = full_proves(full_src, smi)
    for counts in launches["full_prove"]:
        assert (counts["b2"], counts["b3"]) == (0, 0), counts
    # one four-step transform per LDE stage: two sub-NTTs and one twiddle
    for counts in launches["full_prove_mxu"]:
        assert (counts["b2"], counts["b3"]) == (4, 2), counts
    if opts.profile:
        profile_prove(*starks["full_prove"], opts.profile)
    counts = launches["full_prove_mxu"][0]
    del starks

    if not opts.mesh:
        # 7. the streamed prover: bytes, checkpoints, kernels at its shapes,
        # and the FRI 2^22 prove through the default stream_min
        stream_bytes(proof_small)
        stream_checkpoint(proof_small)
        stream_kernels()
        runs = stream_proves(
            STREAM_LOG2_CYCLES, smi,
            [("resident", {})] + stream_plans(STREAM_CLASSES)
            + [("streamed_plain_quotients",
                {"stream_classes": STREAM_CLASSES[0]})])
        assert runs[1]["fri_domain"] == 1 << 22 and runs[1]["block"] == STREAM_S
        # the JAX rule's groups; stream_proves held every B1, B2 and B3
        # count to its class groups (B1 against the resident prove's)
        assert [run["group"] for run in runs[1:]] == [8, 8, 2, 2, 8], [
            run["group"] for run in runs]
        streamed = {**{k: runs[1]["launches"][k]
                       for k in ("b1", "f1", "f2", "f3", "f4")},
                    **{k: runs[2]["launches"][k] for k in ("b2", "b3")}}
        assert min(streamed.values()) > 0, streamed

        # 8. the reference codec, the DEBUG checks, the polynomial toolbox,
        # soundness parameters
        ref_counts = other_paths(proof_small, smi)

    # 9. the sharded prover: ranks are worker processes sharing the card
    dntt_check()
    mesh_kernels(full_src)
    mesh_bytes(src, proof_small)
    on_mesh = mesh_prove(full_src, proof_full, smi, world=opts.mesh or 2)
    if opts.mesh:
        print(smi, flush=True)
        return
    mesh_counts = {**{k: on_mesh["auto"][0][k]
                      for k in ("b1", "f1", "f2", "f3", "f4")},
                   "b2": on_mesh["mxu"][0]["b2"],
                   "b3": on_mesh["mxu"][0]["b3"]}

    # 10. kernels line (ms at the prover's largest shape of each kernel)
    # (B1: the ext leaf; B2: the extension r-pass, 6,912 x 8,192; B3: the
    # extension rows)
    kernels = [
        kernel_entry("blake2b_words", "stark_brainfuck_tpu_torch/csrc/blake2b.cu",
                     "stark_brainfuck_tpu/ops/pallas_blake2b.py:111",
                     launches["full_prove"][0]["b1"], streamed["b1"],
                     mesh_counts["b1"], ref_counts["b1"], b1, 3,
                     ("n", "W", "msg_len"),
                     "no PyTorch call computes BLAKE2b"),
        kernel_entry("subntt", "stark_brainfuck_tpu_torch/csrc/ntt.cu",
                     "stark_brainfuck_tpu/ops/pallas_ntt.py:204",
                     counts["b2"], streamed["b2"], mesh_counts["b2"],
                     ref_counts["b2"], b2,
                     next(i for i, row in enumerate(b2)
                          if (row["stage"], row["form"])
                          == ("ext", "rows_transposed")),
                     ("form", "rows", "m"),
                     "no PyTorch call computes a Goldilocks NTT"),
        kernel_entry("twiddle_outer", "stark_brainfuck_tpu_torch/csrc/ntt.cu",
                     "stark_brainfuck_tpu/ops/pallas_ntt.py:276",
                     counts["b3"], streamed["b3"], mesh_counts["b3"],
                     ref_counts["b3"], b3, 1,
                     ("rows", "r", "c"),
                     "no PyTorch call computes a mod-p multiply"),
    ]
    # F1-F3 stand for XLA's fusion of the JAX package's field arithmetic,
    # no Pallas kernel; "replaces" names the function each one computes
    field_src = "stark_brainfuck_tpu_torch/csrc/field.cu"
    full = launches["full_prove"][0]
    for key, name, replaces, what, main, at in (
            ("f1", "gl_elementwise", "stark_brainfuck_tpu/ops/field.py:77",
             "field.add:44, sub:52, mul:77",
             next(i for i, r in enumerate(f_rows["f1"])
                  if (r["op"], r["form"]) == ("mul", "contiguous")),
             ("op", "shape", "form")),
            ("f2", "xf_elementwise", "stark_brainfuck_tpu/ops/xfield.py:61",
             "xfield.mul:61, mul_base:83", 0, ("op", "shape", "form")),
            ("f3", "acc_group", "stark_brainfuck_tpu/protocol/stark.py:765",
             "BrainfuckStark._acc_group:765",
             next(i for i, r in enumerate(f_rows["f3"])
                  if r.get("baseline_shape") == "quotients"),
             ("group", "terms", "n", "form"))):
        kernels.append(kernel_entry(
            name, field_src, replaces, full[key], streamed[key],
            mesh_counts[key], ref_counts[key], f_rows[key], main, at,
            "no PyTorch call computes a mod-p multiply",
            replaces_note=f"no pl.pallas_call: the XLA-fused form of {what}",
            extra={"launches_power_tables": full["f3_powers"]}
            if key == "f3" else None))
    # F4 stands for XLA's fusion of each table's quotient stack, staged by
    # the JAX package as comb_quot{ti}: ms and bound of one evaluation (all
    # five tables) resident at N = 2^21
    kernels.append(kernel_entry(
        "quotients", "stark_brainfuck_tpu_torch/csrc/quotients.cu",
        "stark_brainfuck_tpu/protocol/stark.py:797", full["f4"],
        streamed["f4"], mesh_counts["f4"], ref_counts["f4"], f_rows["f4"],
        next(i for i, r in enumerate(f_rows["f4"])
             if (r["form"], r["table"]) == ("resident", "all five")),
        ("form", "table", "n"),
        "no PyTorch call evaluates AIR constraints",
        replaces_note="no pl.pallas_call: the XLA-fused form of "
                      "BrainfuckStark._table_quotient_stack:797, staged as "
                      "comb_quot{ti} (stark.py:1391)",
        extra={"launches_mxu": counts["f4"]}))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
