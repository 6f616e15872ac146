"""Whether the proofs of a window are right: the plain reference proves a
sample of the window's jobs again and each proof of the program is held to
its bytes.

A seeded proof is a determined byte string: the program, its input and the
prover seed fix every commitment, challenge, opening and FRI round, on
every path of the port. So the reference (`reference/bfstark`, a frozen
plain-torch copy of the prover that imports nothing of the program) takes
the job's program text, input and seed, records the trace with its own
interpreter, proves on the device it is given, and the two proofs are
compared byte by byte. Every layer is in the bytes: the trace, the salted
base and extension commitments (LDE and BLAKE2b), the extension scan's
terminals, the quotients and the combination behind the combination root,
the openings of all three trees, and every FRI round down to the last
codeword. Above FRI 2^24, which its resident path cannot hold on an 80 GB
card, the reference proves in classes of 2^21 points.

The jobs to prove again, after the window, are the one with the most
cycles and others drawn from the run's seed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from reference import bfstark as R
from reference.bfstark.protocol import classes as RC

# the numbers compared, each with its limit: (name, limit, "max" or "min")
LIMITS = (
    ("bytes_differing", 0, "max"),
    ("proofs_compared", 1, "min"),
)


def bytes_differing(a: bytes, b: bytes) -> int:
    """Positions at which two byte strings differ, the longer one's extra
    bytes included."""
    n = min(len(a), len(b))
    x = np.frombuffer(a[:n], dtype=np.uint8)
    y = np.frombuffer(b[:n], dtype=np.uint8)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def reference_proof(source: str, input_data: str, seed: int, stark: dict,
                    device, resident_max: int = RC.RESIDENT_MAX,
                    classes: Optional[int] = None) -> bytes:
    """The reference's proof of one job: on its resident path up to FRI
    domains of `resident_max`, above in `classes` classes."""
    program = R.VirtualMachine.compile(source)
    trace = R.VirtualMachine.simulate(program, input_data)
    prover = RC.ClassStark(
        trace["processor"].shape[0], trace["memory"].shape[0], program,
        input_data, trace["output_data"], R.StarkConfig(seed=seed, **stark),
        device=device, resident_max=resident_max, classes=classes,
    )
    return prover.prove(trace["processor"], trace["memory"],
                        trace["instruction"], trace["input"], trace["output"])


def sample(count: int, total: int, seed: int,
           first: Optional[int] = None) -> List[int]:
    """`count` distinct job indices of `total`, drawn from the run's seed;
    `first`, where given, is always among them and the others are drawn
    from the rest."""
    s = seed % (1 << 128)
    rng = np.random.default_rng([s & ((1 << 64) - 1), s >> 64, 2])
    k = min(count, total)
    if first is None:
        return sorted(int(i) for i in rng.choice(total, size=k,
                                                 replace=False))
    rest = [i for i in range(total) if i != first]
    drawn = rng.choice(len(rest), size=k - 1, replace=False) if k > 1 else []
    return sorted([first] + [rest[int(i)] for i in drawn])


def judge(jobs: Sequence, stark: dict, count: int, seed: int,
          device) -> Dict[str, dict]:
    """{number: {"value", "limit", "ok"}} over a sample of `jobs` (each
    with .source, .input, .seed, .cycles and .proof): the job with the most
    cycles, and others drawn from the seed."""
    differing = 0
    longest = (max(range(len(jobs)), key=lambda i: jobs[i].cycles)
               if jobs else None)
    picked = sample(count, len(jobs), seed, first=longest)
    for i in picked:
        job = jobs[i]
        want = reference_proof(job.source, job.input, job.seed, stark, device)
        differing += bytes_differing(job.proof, want)
    values = {"bytes_differing": differing, "proofs_compared": len(picked)}
    return {name: {"value": values[name], "limit": limit,
                   "ok": (values[name] <= limit if kind == "max"
                          else values[name] >= limit)}
            for name, limit, kind in LIMITS}
