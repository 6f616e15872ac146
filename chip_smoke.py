"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Drives `stark_brainfuck_tpu_torch` on the card, phase by phase, one JSON
line each; any failure raises and exits non-zero:

  1. device: `nvidia-smi` name and power limit, torch's device name;
  2. build: compiles every kernel of the path (csrc/*.cu) with nvcc;
  3. B1 checks: the BLAKE2b kernel against its plain torch version and
     `hashlib` at the prover's shapes, with CUDA-event times;
  4. bytes across devices: a seeded N=16384 prove on cuda and on cpu must
     give the same bytes, and both must verify;
  5. full-size prove: a counter program of 2^15 cycles (FRI domain 2^21,
     the largest resident one), a warm-up prove, two timed proves, verify;
     kernel launch counts and the peak device memory at each stage mark
     are read from the first timed prove;
  6. the kernels line, then the card's name and power limit;
  7. last line: {"ok": true, "device": {...}}.

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

# trace cycles of the full-size prove, and the message count of the B1
# checks: the FRI domain is 64x the padded trace, 2^21
LOG2_CYCLES = 15
HASH_N = 1 << 21

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


def make_stark(src: str, seed: int, device):
    from stark_brainfuck_tpu_torch import BrainfuckStark, StarkConfig, VirtualMachine

    program = VirtualMachine.compile(src)
    trace = VirtualMachine.simulate(program)
    bfs = BrainfuckStark(
        trace["processor"].shape[0], trace["memory"].shape[0], program, "",
        trace["output_data"], StarkConfig(seed=seed), device=device,
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace one full-size prove with torch.profiler "
                         "and write its kernel table to DIR")
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from stark_brainfuck_tpu_torch.ops import blake2b as B

    # 1. device
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build every kernel of the path
    t0 = time.time()
    lib = B.build_kernel()
    emit("build", kernels={"blake2b": os.path.relpath(lib)},
         seconds=time.time() - t0)

    # 3. B1 against its plain version and hashlib at the prover's shapes
    b1 = check_b1()

    # 4. the same seeded proof on cuda and on cpu
    src = "+" * 8 + "[->++++[-]<]"
    bfs_gpu, args = make_stark(src, 7, "cuda")
    B.LAUNCHES = 0
    proof_gpu = bfs_gpu.prove(*args)
    launches_small = B.LAUNCHES
    bfs_cpu, _ = make_stark(src, 7, "cpu")
    proof_cpu = bfs_cpu.prove(*args)
    assert bfs_gpu.fri.domain.length >= bfs_gpu.config.device_commit_min
    assert proof_gpu == proof_cpu, "cuda and cpu proofs differ"
    assert bfs_gpu.verify(proof_gpu) and bfs_cpu.verify(proof_cpu)
    assert launches_small > 0, "device-commit prove launched no B1 kernel"
    emit("bytes_across_devices", fri_domain=bfs_gpu.fri.domain.length,
         proof_bytes=len(proof_gpu), identical=True, verified=True,
         b1_launches=launches_small)

    # 5. full-size prove on the card
    target = 1 << LOG2_CYCLES
    src = counter_program(target)
    bfs, args = make_stark(src, 0, "cuda")
    cycles = int(args[0].shape[0])
    t0 = time.time()
    proof = bfs.prove(*args)
    warm_s = time.time() - t0
    assert bfs.verify(proof), "full-size proof failed to verify"
    torch.cuda.reset_peak_memory_stats()
    prove_s = []
    launches = None
    for rep in range(2):
        if rep == 0:
            B.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.time()
        again = bfs.prove(*args)
        torch.cuda.synchronize()
        prove_s.append(time.time() - t0)
        if rep == 0:
            launches = B.LAUNCHES
            stages = bfs.last_metrics["stages_s"]
            peaks = bfs.last_metrics["peak_bytes_at_mark"]
        assert again == proof, "seeded proves differ"
    assert launches > 0, "full-size prove launched no B1 kernel"
    best = min(prove_s)
    emit("full_prove", target_cycles=target, trace_cycles=cycles,
         fri_domain=bfs.fri.domain.length, cycles_per_s=cycles / best,
         prove_s=prove_s, warmup_prove_s=warm_s, stages_s=stages,
         fri_round_s=bfs.last_metrics["fri_round_s"],
         proof_bytes=len(proof), verified=True, b1_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         peak_bytes_at_mark=peaks,
         nvidia_smi=smi)

    if opts.profile:
        profile_prove(bfs, args, opts.profile)

    # 6. kernels line (ms at the prover's largest leaf shape)
    main_shape = b1[3]
    kernels = [{
        "name": "blake2b_words",
        "route": "cuda",
        "source": "stark_brainfuck_tpu_torch/csrc/blake2b.cu",
        "replaces": "stark_brainfuck_tpu/ops/pallas_blake2b.py:111",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in b1),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "at": {k: main_shape[k] for k in ("n", "W", "msg_len")},
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
