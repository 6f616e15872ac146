"""The program's own account of the window's proves, for the metrics that
read its spans and counters.

The program (`stark_brainfuck_tpu_torch.utils.metrics`) keeps a record of
each of its last proves: the prover's seed and a tree of spans, the root
`prove` first, each with its path (`prove/fri.prove/open`), its start and
end on `time.perf_counter_ns()` (the clock of the harness's
`time.perf_counter()`) and `counts`, the counters that moved while it was
open. A window's records are those whose seed is a window job's and whose
prove started inside that job. A program without such records, or another
package in the program's place, has none, and the metrics read None.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional

PROGRAM = "stark_brainfuck_tpu_torch.utils.metrics"
LAUNCHES = ("b1", "b2", "b3", "f1", "f2", "f3", "f3_powers", "f4",
            "f4_prologue", "f5")
BLOCKING = ("sync", "d2h", "h2d")


def window_records(ctx) -> List:
    history = getattr(sys.modules.get(PROGRAM), "history", None)
    if history is None:
        return []
    jobs = {}
    for j in ctx.jobs:
        jobs.setdefault(j.seed, []).append((j.start * 1e9, j.end * 1e9))
    out = []
    for record in history():
        spans = getattr(record, "spans", None)
        if not spans or spans[0].end_ns is None:
            continue
        t = spans[0].start_ns
        if any(a <= t <= b for a, b in jobs.get(record.seed, ())):
            out.append(record)
    return out


def mean(ctx, value: Callable) -> Optional[float]:
    """The mean of value(record) over the window's records that give one;
    None if none does."""
    seen = [v for v in map(value, window_records(ctx)) if v is not None]
    return sum(seen) / len(seen) if seen else None


def span_seconds(match: Callable) -> Callable:
    """value(record): the seconds of the spans whose path `match`es, summed;
    None where the record has none."""
    def value(record):
        spans = [s for s in record.spans if match(s.path)]
        if not spans:
            return None
        return sum(s.end_ns - s.start_ns for s in spans) / 1e9
    return value


def root_count(names) -> Callable:
    """value(record): the counters `names` summed over the whole prove."""
    def value(record):
        counts = record.spans[0].counts
        return sum(counts.get(k, 0) for k in names)
    return value
