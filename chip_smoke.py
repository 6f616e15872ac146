"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR] [--b2-sweep] [--b2-parts]
                          [--stream-log2-cycles K] [--ref-codec]
                          [--mesh [RANKS]]

Drives `stark_brainfuck_tpu_torch` on the card, phase by phase, one JSON
line each; any failure raises and exits non-zero:

  1. device: `nvidia-smi` name and power limit, torch's device name;
  2. build: compiles every kernel source (csrc/*.cu) with nvcc, one
     process each, all started together;
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
  5. bytes across devices: a seeded N=16384 prove on cuda and on cpu must
     give the same bytes, and both must verify; the same again with
     `ntt_backend="mxu"` (kernels B2/B3), whose bytes must equal the
     default backend's;
  6. full-size prove: a counter program of 2^15 cycles (FRI domain 2^21,
     the largest resident one) on the default NTT path (full_prove) and
     with `ntt_backend="mxu"` (full_prove_mxu): a warm-up prove and verify
     each, then two timed proves each, in turns, every one with its kernel
     launch counts, stage times and peak device memory at each stage mark;
     all proofs byte-identical;
  7. the streamed prover (FRI domains >= `stream_min`, strided classes):
     stream_bytes: the N=16384 program with `stream_min=1,
     stream_classes=4` on cuda and on cpu, on both NTT paths, every proof
     equal to the resident one of step 5; stream_checkpoint: the same with
     a `checkpoint_dir`, whose second prove resumes both commit stages to
     the same bytes; stream_kernels: B1 against its plain version at the
     streamed shapes (S = 2^17 messages: both leaf widths, the salt PRF, a
     pair combine; the ladder's levels of 2^16 and 1,024 parents; the 2^22
     leaves and pair messages of the combination's tree), B2 and B3 against
     their plain versions in the launches of the size-S class transform
     (c = 256, r = 512; 19 and 27 rows), and `block_values` on B2/B3
     against the u64 network at (19, S) and (27, S), all exactly;
     stream_prove: a counter of 2^16 cycles
     (FRI 2^22, which the default `stream_min` sends down the streamed
     path) proved resident (`stream_min` = 2^23) and streamed with 32 and
     with 2 classes, each on both NTT paths, all bytes equal, with launch
     counts, stage times and peak memory per prove;
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
     offset tables, and B1 at the block's leaf, salt and tree-level sizes,
     each against its plain version, exactly; mesh_bytes: the N=16384
     program with `mesh_shape` 2 and 4, on cuda and on cpu, default and mxu, every rank's proof equal to step
     5's single-device proof, one verified; mesh_prove: the 2^15-cycle
     counter (FRI 2^21) on 2 ranks, default and mxu, a warm-up and a timed
     prove each, bytes equal to step 6's, and per rank the stage times, the
     bytes and seconds spent in collectives, peak device memory and
     B1/B2/B3 launches (every rank must launch B1, and B2 and B3 under
     mxu). A worker that fails makes the script exit non-zero;
  10. the card's name and power limit, then the kernels line;
  11. last line: {"ok": true, "device": {...}}.

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
and verified, prints one stream_prove line each and stops.

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
# and the SM's instruction issue ceiling for 32-bit integer work = 132 SMs x
# 4 schedulers x 32 lanes x 1.98 GHz boost. nvcc spreads integer adds over
# the INT32 pipe and the FMA pipe (IMAD), so the INT32 pipe's 64 lanes/clock
# alone is no lower bound: the kernel measured faster than it.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# fewest 32-bit integer instructions per BLAKE2b compression: 96
# G-functions of 4 three-input 64-bit adds (2 IADD3 each), 4 xors (2 LOP3
# each) and 3 funnel rotates (2 SHF each; the rotate by 32 is a free half
# swap), plus the 8-word feed-forward h ^= v ^ v' (2 LOP3 each)
OPS_PER_COMPRESSION = 96 * (4 * 2 + 4 * 2 + 3 * 2) + 8 * 2
# fewest 32-bit integer instructions per Goldilocks operation of
# csrc/ntt.cu: a multiply is the 128-bit product (4 wide 32x32 partial
# products, 4 carry adds) and its reduction (subtract hh with borrow 2,
# hl*(2^32-1) as shift-subtract 2, add with carry 2, two conditional
# corrections 2 each) = 18; an add is a 64-bit add 2, its wrap
# correction 2 and the compare-subtract of p 2 = 6; a sub is 2 + 2 = 4.
# A multiply by a power of two needs no wide product (it is a shift), so
# only its reduction counts, 10; a multiply by 1 counts nothing
GL_MUL_OPS = 18
GL_POW2_MUL_OPS = 10
GL_ADD_OPS = 6
GL_SUB_OPS = 4

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


def sass_counts(library: str):
    """{kernel: {"total": SASS instructions in its code, "opcodes": the
    eight most frequent base opcodes and their counts}} of a built library,
    read from `cuobjdump -sass`; None where the toolkit has no cuobjdump."""
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
        opcodes = collections.Counter(
            op.split(".")[0] for op in re.findall(
                r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                chunk, flags=re.M))
        counts[short] = {"total": sum(opcodes.values()),
                         "opcodes": dict(opcodes.most_common(8))}
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
        blocks = W // 16
        ops = n * blocks * OPS_PER_COMPRESSION
        nbytes = (W * 8 + 64) * n
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        bound_by = (
            "operations" if ops / INT32_OPS_PER_S >= nbytes / HBM_BYTES_PER_S
            else "bytes"
        )
        row = {
            "n": n, "W": W, "msg_len": msg_len, "max_abs_err": err,
            "hashlib_rows": len(rows), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit("b1_check", **row)
        results.append(row)
        del words, got, plain
    return results


def bound(nbytes: float, ops: float):
    """(bound ms, what bounds it): the larger of the bytes over HBM
    bandwidth and the 32-bit integer instructions over the issue ceiling."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def subntt_ops(m: int) -> int:
    """Fewest 32-bit integer instructions of one m-point radix-2 NTT row.
    Every butterfly adds and subtracts. Its multiply by the twiddle
    w_{2h}^j (j < h, in the stage of half-width h) is no work for j = 0,
    a reduction only when the twiddle is a 64th root of unity (the field's
    are the powers of 8 = 2^3, so the product is a shift), and a full
    multiply otherwise."""
    ops, half = 0, 1
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
        bound_ms, _ = bound(2 * 16 * k * n, 0)
        emit("ntt_full", stage=stage, rows=k, n=n, r=plan.r, c=plan.c,
             max_abs_err=err, kernel_ms=kernel_ms, u64_ms=u64_ms,
             bound_ms=bound_ms)
        del v
    return b2, b3


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
    device's busy share of the wall time, and B1's share; the full table
    goes to out_dir/profile_prove.txt."""
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
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_prove.txt"), "w") as fh:
        fh.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    emit("profile", wall_s=wall, device_busy_s=device_s,
         device_busy_share=device_s / wall, b1_device_s=b1_s,
         top=[{"kernel": e.key[:80], "calls": e.count,
               "device_s": e.self_device_time_total / 1e6}
              for e in events[:12]])


def reset_counts():
    from stark_brainfuck_tpu_torch.ops import blake2b as B
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as K

    B.LAUNCHES = 0
    K.LAUNCHES_SUBNTT = 0
    K.LAUNCHES_TWIDDLE = 0


def read_counts():
    """Launches of B1, B2 and B3 since the last reset_counts()."""
    from stark_brainfuck_tpu_torch.ops import blake2b as B
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as K

    return {"b1": B.LAUNCHES, "b2": K.LAUNCHES_SUBNTT,
            "b3": K.LAUNCHES_TWIDDLE}


def full_proves(src, smi):
    """The full-size prove on the default and the mxu NTT path: a warm-up
    prove and verify for each, then two timed proves each, in turns
    (default, mxu, mxu, default) so the two are compared on the same card
    in the same state. Launch counts are set to 0 just before each timed
    prove and read just after it; stage times and peak bytes are kept per
    prove. Every proof must equal the default path's warm-up bytes.
    Returns ({path: (stark, args)}, {path: launch counts per prove}, the
    proof)."""
    paths = {"full_prove": {}, "full_prove_mxu": {"ntt_backend": "mxu"}}
    starks, warm, runs = {}, {}, {p: [] for p in paths}
    proof = None
    for phase, config in paths.items():
        bfs, args = make_stark(src, 0, "cuda", **config)
        t0 = time.time()
        got = bfs.prove(*args)
        warm[phase] = time.time() - t0
        assert bfs.verify(got), f"{phase}: proof failed to verify"
        proof = proof or got
        assert got == proof, f"{phase}: bytes differ from the default path"
        starks[phase] = (bfs, args)
    for phase in ("full_prove", "full_prove_mxu", "full_prove_mxu",
                  "full_prove"):
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
        runs[phase].append({
            "prove_s": wall, "launches": counts,
            "stages_s": bfs.last_metrics["stages_s"],
            "fri_round_s": bfs.last_metrics["fri_round_s"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "peak_bytes_at_mark": bfs.last_metrics["peak_bytes_at_mark"],
        })
    for phase, (bfs, args) in starks.items():
        rs = runs[phase]
        cycles = int(args[0].shape[0])
        emit(phase, target_cycles=1 << LOG2_CYCLES, trace_cycles=cycles,
             fri_domain=bfs.fri.domain.length,
             cycles_per_s=cycles / min(r["prove_s"] for r in rs),
             prove_s=[r["prove_s"] for r in rs], warmup_prove_s=warm[phase],
             ntt_path=bfs.last_metrics["ntt_path"], proof_bytes=len(proof),
             verified=True, identical_to_default=True, runs=rs,
             nvidia_smi=smi)
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
        # S = 4096 is one sub-transform: a B2 launch and no B3 for each of
        # the 6 class transforms of each of the 4 classes
        assert counts["b1"] > 0 and (counts["b2"], counts["b3"]) == (
            (24, 0) if backend == "mxu" else (0, 0)), counts
        emit("stream_bytes", ntt_backend=backend,
             fri_domain=bfs_gpu.fri.domain.length,
             classes=bfs_gpu.last_metrics["stream_classes"],
             block=bfs_gpu.last_metrics["stream_block"],
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
    S = 2^17). B1 against its plain version: a class's two leaf widths, its
    salt PRF and a pair combine at S messages, two levels of the ladder
    (`merkle_parents` to 2^16 and to 1,024 parents), and the 2^22 leaves
    and 128-byte messages of the combination's tree. B2 and B3 against
    their plain versions in the launches of the size-S class transform:
    the column pass, the row pass with its transposed store, and the outer
    twiddle, for the 19 base and the 27 extension rows. Then `block_values`
    on B2/B3 against the u64 network for both groups. Exact, or it
    raises."""
    from stark_brainfuck_tpu_torch.ops import blake2b as B
    from stark_brainfuck_tpu_torch.ops import field as f
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as K
    from stark_brainfuck_tpu_torch.protocol import stream

    S = STREAM_S
    N = S * STREAM_CLASSES[0]
    b1_cases = [(S, 32, 176, "leaf"), (S, 32, 240, "leaf"),
                (S, 16, 24, "salt"), (S, 16, 128, "pair"),
                (S // 2, 16, 128, "ladder"), (1024, 16, 128, "ladder"),
                (N, 16, 24, "leaf"), (N, 16, 128, "parents")]
    for k, (n, W, msg_len, use) in enumerate(b1_cases):
        words = random_messages(n, W, msg_len, seed=40 + k)
        if use == "pair":
            left, right = words[:, :8].contiguous(), words[:, 8:].contiguous()
            run = lambda: B.merkle_parents_pair(left, right)
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
        x = random_field(rows, S, 50 + rows)
        for form, sub, batches, nvec, src, dst in b2_forms(plan, rows)[:2]:
            run = lambda: K.subntt_tiled(x, sub, batches, nvec, src, dst)
            run_plain = lambda: K.subntt_tiled_plain(
                x, sub, batches, nvec, src, dst)
            err = max_abs_err(run(), run_plain())
            assert err == 0.0, f"B2 differs from plain torch at {(form, stage)}"
            bound_ms, bound_by = bound(
                16 * rows * S + 8 * sub.table.numel(),
                batches * nvec * subntt_ops(sub.m))
            emit("stream_kernels", kernel="subntt", stage=stage, form=form,
                 rows=batches * nvec, m=sub.m, tile=K.tile_shape(sub.m, True),
                 max_abs_err=err, ms=cuda_ms(run, reps=20),
                 plain_ms=cuda_ms(run_plain, reps=3), bound_ms=bound_ms,
                 bound_by=bound_by)
        y = x.reshape(rows * plan.c, plan.r)
        err = max_abs_err(K.twiddle_outer(y, plan),
                          K.twiddle_outer_plain(y, plan))
        assert err == 0.0, f"B3 differs from plain torch at {tuple(y.shape)}"
        bound_ms, bound_by = bound(
            16 * rows * S + 8 * (128 + plan.c // 128) * plan.r,
            2 * GL_MUL_OPS * rows * S)
        emit("stream_kernels", kernel="twiddle_outer", stage=stage,
             rows=rows * plan.c, r=plan.r, c=plan.c, hi_rows=plan.c // 128,
             max_abs_err=err,
             ms=cuda_ms(lambda: K.twiddle_outer(y, plan), reps=20),
             plain_ms=cuda_ms(lambda: K.twiddle_outer_plain(y, plan), reps=3),
             bound_ms=bound_ms, bound_by=bound_by)
        del x, y
    wb = f.powers(omega, 4, "cuda")[3:4]
    for stage, rows in NTT_ROWS.items():
        # the prove's groups: 3 randomizer rows of N/4 coefficients, the
        # rest table columns of height + 1 (one randomizer)
        groups = (random_field(3, N // 4, 60 + rows),
                  random_field(rows - 3, (N >> 6) + 1, 61 + rows))
        run = {kernel: (lambda plan=plan: stream.block_values(
            groups, wb, N // 4, plan["pack_S"], S))
            for kernel, plan in plans.items()}
        reset_counts()
        got = run[True]()
        counts = read_counts()
        want = run[False]()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        assert err == 0.0, f"block_values on B2/B3 differs at {(rows, S)}"
        assert (counts["b2"], counts["b3"]) == (2, 1), counts
        del got, want
        # the class transform alone (B2, B3, B2 against the u64 network):
        # the rest of `block_values` is the scale row and the fold
        folded = random_field(rows, S, 62 + rows)
        emit("stream_kernels", kernel="block_values", stage=stage, rows=rows,
             S=S, r=plan.r, c=plan.c, max_abs_err=err,
             kernel_ms=cuda_ms(run[True], reps=10),
             u64_ms=cuda_ms(run[False], reps=3),
             transform_kernel_ms=cuda_ms(
                 lambda: K.forward_ntt(folded, plan), reps=20),
             transform_u64_ms=cuda_ms(
                 lambda: K.forward_ntt(folded, plans[False]["pack_S"]),
                 reps=3))
        del groups, folded


def stream_plans(classes, backends=("auto", "mxu")):
    """(kind, config) of a streamed prove for each class count and NTT
    backend."""
    return [("streamed", {"stream_classes": B, "ntt_backend": nb})
            for B in classes for nb in backends]


def stream_proves(log2_cycles, smi, plans):
    """A counter of 2^log2_cycles cycles proved once for each (kind, config)
    of `plans`: "streamed", or "resident", the same claim with `stream_min`
    raised past its domain.
    Each with the launch counts set to 0 just before it and read just
    after, stage times and peak bytes. All proofs must be equal and the
    first must verify. Returns the runs."""
    from stark_brainfuck_tpu_torch import VirtualMachine

    src = counter_program(1 << log2_cycles)
    trace = VirtualMachine.simulate(VirtualMachine.compile(src))
    cycles = int(trace["processor"].shape[0])
    proof, runs = None, []
    for kind, config in plans:
        if kind == "resident":
            config = {**config, "stream_min": 1 << (log2_cycles + 7)}
        bfs, args = make_stark(src, 0, "cuda", trace=trace, **config)
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
        mxu = config.get("ntt_backend") == "mxu"
        if kind != "resident":
            # 6 class transforms a class: one a group in the two commit
            # passes, the combination and the reopen; each 2 B2 and 1 B3
            transforms = 6 * m["stream_classes"] if mxu else 0
            assert (counts["b2"], counts["b3"]) == (
                2 * transforms, transforms), counts
        else:
            assert (counts["b2"], counts["b3"]) == (0, 0), counts
        run = {"kind": kind, "ntt_backend": config.get("ntt_backend", "auto"),
               "ntt_path": m["ntt_path"], "classes": m["stream_classes"],
               "block": m["stream_block"], "trace_cycles": cycles,
               "fri_domain": m["fri_domain"], "prove_s": wall,
               "cycles_per_s": cycles / wall, "launches": counts,
               "stages_s": m["stages_s"],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "peak_bytes_at_mark": m["peak_bytes_at_mark"],
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
        launches.update({"b1": counts["b1"]} if backend == "auto" else
                        {"b2": counts["b2"], "b3": counts["b3"]})
        assert got == proof, "ref_codec_bytes: the NTT paths differ"
        assert got != native_proof, "ref_codec_bytes: equals the native proof"
        assert bfs.verify(got), bfs.last_rejection
        assert counts["b1"] > 0, counts
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
    leaves, salts and tree levels against `blake2b_words_plain`. Times are
    not taken: the ranks share the card."""
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
        got = read_counts()
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
                assert r["launches"] == want, (world, route, rank, r)
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


def mesh_kernels(world=2):
    """B1, B2 and B3 on every rank of a `world`-rank mesh at the shapes of
    the full-width mesh prove (`rank_kernels`): any difference raises in
    the rank and fails the run."""
    ranks = spawn_on("cuda", "rank_kernels", world, None)
    assert [r["rank"] for r in ranks] == list(range(world))
    for r in ranks:
        names = {c["kernel"] for c in r["cases"]}
        assert names == {"blake2b_words", "subntt", "twiddle_outer"}, names
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
                 launches_mesh, launches_ref, rows, main, at):
    """One row of the kernels line: ms, plain_ms and bound at the main
    shape `rows[main]`, the largest error over every checked shape;
    `launches` of the resident full-size prove, `launches_streamed` of the
    streamed one (32 classes), `launches_mesh` of one rank of the 2-rank
    mesh prove and `launches_ref` of the ref-codec prove at FRI 2^14 (B2
    and B3: on the mxu path)."""
    main_shape = rows[main]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
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
        "at": {k: main_shape[k] for k in at},
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

    # 2. build every kernel source, in parallel
    t0 = time.time()
    libs = cuda_build.build()
    ptxas = {}
    for name, lib in libs.items():
        log = lib[:-3] + ".log"
        if os.path.exists(log):
            with open(log) as fh:
                ptxas[name] = [ln.strip() for ln in fh
                               if "Used" in ln or "spill" in ln]
    emit("build", kernels={k: os.path.relpath(v) for k, v in libs.items()},
         seconds=time.time() - t0, ptxas=ptxas,
         sass_instructions={k: sass_counts(v) for k, v in libs.items()})
    assert {"blake2b", "ntt"} <= set(libs), libs

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
    if not (opts.mesh or opts.ref_codec):
        # 3. B1 against its plain version and hashlib at the prover's shapes
        b1 = check_b1()

        # 4. B2 / B3 against their plain versions; the composed transform
        # against the u64 network
        check_b2_every_size()
        b2, b3 = check_ntt_kernels()

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
    full_src = counter_program(1 << LOG2_CYCLES)
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
        runs = stream_proves(STREAM_LOG2_CYCLES, smi,
                             [("resident", {})] + stream_plans(STREAM_CLASSES))
        assert runs[1]["fri_domain"] == 1 << 22 and runs[1]["block"] == STREAM_S
        for run in runs[1:]:
            assert run["launches"]["b1"] > runs[0]["launches"]["b1"], run
        streamed = {"b1": runs[1]["launches"]["b1"], **{
            k: runs[2]["launches"][k] for k in ("b2", "b3")}}
        assert min(streamed.values()) > 0, streamed

        # 8. the reference codec, the DEBUG checks, the polynomial toolbox,
        # soundness parameters
        ref_counts = other_paths(proof_small, smi)

    # 9. the sharded prover: ranks are worker processes sharing the card
    dntt_check()
    mesh_kernels()
    mesh_bytes(src, proof_small)
    on_mesh = mesh_prove(full_src, proof_full, smi, world=opts.mesh or 2)
    if opts.mesh:
        print(smi, flush=True)
        return
    mesh_counts = {"b1": on_mesh["auto"][0]["b1"],
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
                     ("n", "W", "msg_len")),
        kernel_entry("subntt", "stark_brainfuck_tpu_torch/csrc/ntt.cu",
                     "stark_brainfuck_tpu/ops/pallas_ntt.py:204",
                     counts["b2"], streamed["b2"], mesh_counts["b2"],
                     ref_counts["b2"], b2,
                     next(i for i, row in enumerate(b2)
                          if (row["stage"], row["form"])
                          == ("ext", "rows_transposed")),
                     ("form", "rows", "m")),
        kernel_entry("twiddle_outer", "stark_brainfuck_tpu_torch/csrc/ntt.cu",
                     "stark_brainfuck_tpu/ops/pallas_ntt.py:276",
                     counts["b3"], streamed["b3"], mesh_counts["b3"],
                     ref_counts["b3"], b3, 1,
                     ("rows", "r", "c")),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
