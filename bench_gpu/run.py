"""The benchmark of stark_brainfuck_tpu_torch, the Brainfuck STARK prover on
NVIDIA GPUs: one run of one cell, from the root of a checkout.

    python3 bench_gpu/run.py --workload NAME --seed N --seconds S --trace 0|1

It prints the card's facts and the window's counts on earlier lines, each
number compared for `correct` beside its limit as the last lines on
standard error, and one JSON object as the last line on standard output:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}. With --trace 0 the metrics are the cell's end-to-end
ones, with --trace 1 its per-layer ones. Without a CUDA card, or with
fewer than the cell asks for, it exits with 3 and prints no result; if JAX
or the JAX package was loaded, with 4.
"""

import time

STARTED = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)  # the program, stark_brainfuck_tpu_torch

import cells  # noqa: E402
import guard  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = cells.load_benchmark(ROOT)
    cell = cells.find_cell(bench, args.workload)
    chips = int(cell.get("chips", 1))
    # the configuration may fix the host's threads (torch's intra-op pool
    # and the program's OpenMP loops); this has to happen before either loads
    threads = cells.load_config(cell["config"]).get("host_threads")
    if threads is not None:
        os.environ["OMP_NUM_THREADS"] = str(int(threads))

    import torch

    if threads is not None:
        torch.set_num_threads(int(threads))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    import card
    import harness

    print(json.dumps({"card": card.smi_facts(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", started=STARTED,
                         bench=bench)
    bad = guard.forbidden_modules()
    if bad:
        print("no result: the run loaded " + ", ".join(bad), file=sys.stderr)
        return 4
    print(json.dumps({"window": result.pop("window"),
                      "card_after": card.smi_facts()}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
