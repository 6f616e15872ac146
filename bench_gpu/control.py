"""The control of `correct`: the plain reference put in the program's place
with one guarantee of the configuration broken, which the judgement has to
find.

The configurations state no floating-point precision (the prover computes
in exact field arithmetic), so the control breaks a guarantee they state:
it proves with no randomizers (`num_randomizers` 0), so the proof is no
longer zero-knowledge. Such a proof may still convince a verifier; only the
comparison with the reference's bytes shows what was left out.

    python3 bench_gpu/control.py --workload NAME --seconds S --seeds A B C

runs a short window of the cell with the control proving, for each seed,
and prints each run's numbers compared and whether the run came out
correct. It needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the guarantee the control breaks
BROKEN = {"num_randomizers": 0}


def control_program(broken=None):
    """A stand-in for the program's package: the reference's prover (its
    class path above the FRI domains its resident path holds), with
    `broken` overriding the configuration it is given."""
    from reference import bfstark as R
    from reference.bfstark.protocol.classes import ClassStark

    broken = dict(BROKEN if broken is None else broken)
    return SimpleNamespace(
        VirtualMachine=R.VirtualMachine,
        BrainfuckStark=ClassStark,
        StarkConfig=lambda **kw: R.StarkConfig(**{**kw, **broken}),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        result = harness.run(args.workload, seed, args.seconds, False,
                             device="cuda", program=control_program())
        print(json.dumps({"control": args.workload, "seed": seed,
                          "broken": BROKEN, "correct": result["correct"],
                          "checks": result["checks"],
                          "window": {k: v for k, v in result["window"].items()
                                     if k not in ("job_s", "host_s")}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
