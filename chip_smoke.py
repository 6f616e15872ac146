"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR] [--b2-sweep] [--b2-parts]

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
  7. the kernels line, then the card's name and power limit;
  8. last line: {"ok": true, "device": {...}}.

`--b2-sweep` and `--b2-parts` are measuring aids for kernel B2: after the
build they time it under several tile shapes, or with its arithmetic or
its memory traffic cut out of the source, print one JSON line each and
stop before the checks.

Needs one CUDA card; without one it exits non-zero and prints no result.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
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


def make_stark(src: str, seed: int, device, **config):
    from stark_brainfuck_tpu_torch import BrainfuckStark, StarkConfig, VirtualMachine

    program = VirtualMachine.compile(src)
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
    Returns ({path: (stark, args)}, {path: launch counts per prove})."""
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
    return starks, {p: [r["launches"] for r in rs] for p, rs in runs.items()}


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


def kernel_entry(name, source, replaces, launches, rows, main, at):
    """One row of the kernels line: ms, plain_ms and bound at the main
    shape `rows[main]`, the largest error over every checked shape."""
    main_shape = rows[main]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "at": {k: main_shape[k] for k in at},
    }


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
    opts = ap.parse_args()

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

    if opts.b2_sweep or opts.b2_parts:
        if opts.b2_sweep:
            b2_sweep()
        if opts.b2_parts:
            b2_parts()
        print(smi, flush=True)
        return

    # 3. B1 against its plain version and hashlib at the prover's shapes
    b1 = check_b1()

    # 4. B2 / B3 against their plain versions; the composed transform
    # against the u64 network
    check_b2_every_size()
    b2, b3 = check_ntt_kernels()

    # 5. the same seeded proof on cuda and on cpu, default and mxu NTT
    src = "+" * 8 + "[->++++[-]<]"
    proof_small, _ = bytes_across_devices("bytes_across_devices", src)
    _, counts = bytes_across_devices(
        "bytes_across_devices_mxu", src, want=proof_small, ntt_backend="mxu"
    )
    assert counts["b2"] > 0 and counts["b3"] > 0, (
        "mxu prove launched no B2/B3 kernel"
    )

    # 6. full-size prove on the card, default and mxu NTT in turns
    starks, launches = full_proves(counter_program(1 << LOG2_CYCLES), smi)
    for counts in launches["full_prove"]:
        assert (counts["b2"], counts["b3"]) == (0, 0), counts
    # one four-step transform per LDE stage: two sub-NTTs and one twiddle
    for counts in launches["full_prove_mxu"]:
        assert (counts["b2"], counts["b3"]) == (4, 2), counts
    if opts.profile:
        profile_prove(*starks["full_prove"], opts.profile)
    counts = launches["full_prove_mxu"][0]

    # 7. kernels line (ms at the prover's largest shape of each kernel)
    # (B1: the ext leaf; B2: the extension r-pass, 6,912 x 8,192; B3: the
    # extension rows)
    kernels = [
        kernel_entry("blake2b_words", "stark_brainfuck_tpu_torch/csrc/blake2b.cu",
                     "stark_brainfuck_tpu/ops/pallas_blake2b.py:111",
                     launches["full_prove"][0]["b1"], b1, 3,
                     ("n", "W", "msg_len")),
        kernel_entry("subntt", "stark_brainfuck_tpu_torch/csrc/ntt.cu",
                     "stark_brainfuck_tpu/ops/pallas_ntt.py:204",
                     counts["b2"], b2,
                     next(i for i, row in enumerate(b2)
                          if (row["stage"], row["form"])
                          == ("ext", "rows_transposed")),
                     ("form", "rows", "m")),
        kernel_entry("twiddle_outer", "stark_brainfuck_tpu_torch/csrc/ntt.cu",
                     "stark_brainfuck_tpu/ops/pallas_ntt.py:276",
                     counts["b3"], b3, 1, ("rows", "r", "c")),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
