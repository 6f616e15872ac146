"""The prover's span recorder: one record a prove, a tree of spans in it.

`BrainfuckStark.prove` opens a `SpanRecorder`, which becomes the process's
current record until the prove returns. The record holds a process-wide
`prove_id`, the prover's `config.seed` (a job's id where seeds are drawn a
job) and a flat list of spans, the root `prove` first. A span keeps its
name, its path (`prove/stage_a (base LDE)/tables`), its parent's index,
its start and end on `time.perf_counter_ns()`, and the counters (below)
that moved while it was open.

The children of the root are the stages: `stage(label)` ends the open
stage and opens the next at the same instant, so the stages tile the prove
and `stages_s` keeps the marks' labels, order and seconds. On a CUDA device
a stage ends with a device synchronise, in a child span `sync`, so that its
kernels are billed to it and not to whichever later stage first waits on
them, and records `torch.cuda.max_memory_allocated()` as it stands there:
the first stage that reaches the final value holds the peak. Code under a
stage opens children with `span(name)`, a no-op when no prove is recording.

While torch's profiler runs, each span also enters a profiler range under
its path (`_profiler_range`), so a profiled job's trace holds the spans on
the timeline of its kernels. With no profiler a span costs two clock reads
and two counter snapshots.

Counters: the hand-written kernels' launch counters (B1 `b1`, B2 `b2`, B3
`b3`, F1 `f1`, F2 `f2`, F3 `f3` and its power tables `f3_powers`, F4 `f4`
and its prologue `f4_prologue`, F5 `f5`) and the host's blocking points:
device synchronises (`sync`), reads from a CUDA device (`d2h`) and uploads
to one (`h2d`), each with its calls, bytes (`*_bytes`) and the host
nanoseconds spent inside it (`*_ns`). Every transfer of the prove path
goes through `transfer`, every synchronise through `device_sync`. And the
program's tallies: `open_runs`, the 2^cut-leaf runs of Merkle trees that
openings hash again on the device (`count_open_runs`).

The last `HISTORY_LEN` records of the process are kept; `history()` reads
them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
from time import perf_counter_ns
from typing import Dict, List, Optional

import torch

HISTORY_LEN = 1024
LAUNCH_COUNTERS = ("b1", "b2", "b3", "f1", "f2", "f3", "f3_powers", "f4",
                   "f4_prologue", "f5")
BLOCKING_COUNTERS = ("sync", "sync_ns", "d2h", "d2h_bytes", "d2h_ns", "h2d",
                     "h2d_bytes", "h2d_ns")
TALLY_COUNTERS = ("open_runs",)
COUNTERS = LAUNCH_COUNTERS + BLOCKING_COUNTERS + TALLY_COUNTERS
_SYNC, _D2H, _H2D = 0, 2, 5  # offsets of each kind's calls in _BLOCKING

_BLOCKING = [0] * len(BLOCKING_COUNTERS)
_TALLIES = [0] * len(TALLY_COUNTERS)
_HISTORY: "collections.deque[ProveRecord]" = collections.deque(
    maxlen=HISTORY_LEN)
_prove_ids = itertools.count(1)
_local = threading.local()
_CPU = torch.device("cpu")
_snapshot = None


def counters() -> tuple:
    """Every counter's value now, in the order of `COUNTERS`."""
    global _snapshot
    if _snapshot is None:
        # the kernel modules import this one (through convert.py)
        from ..ops import blake2b as b1
        from ..ops import field_kernels as fk
        from ..ops import fri_kernels as fr
        from ..ops import kernel_ntt as kn
        from ..ops import quotient_kernels as qk

        def _snapshot():
            return (b1.LAUNCHES, kn.LAUNCHES_SUBNTT, kn.LAUNCHES_TWIDDLE,
                    fk.LAUNCHES_ELEMENTWISE, fk.LAUNCHES_XFIELD,
                    fk.LAUNCHES_ACC, fk.LAUNCHES_ACC_POWERS,
                    qk.LAUNCHES_QUOTIENT, qk.LAUNCHES_QUOTIENT_PROLOGUE,
                    fr.LAUNCHES_FOLD, *_BLOCKING, *_TALLIES)
    return _snapshot()


def count_open_runs(runs: int):
    """`runs` more 2^cut-leaf runs hashed on the device for openings."""
    _TALLIES[0] += runs


def _count(kind: int, nbytes: int, t0: int):
    """One more call of `kind` (its offset in `_BLOCKING`: a synchronise
    keeps calls and ns, a transfer calls, bytes and ns), begun at `t0`."""
    _BLOCKING[kind] += 1
    if kind != _SYNC:
        _BLOCKING[kind + 1] += nbytes
    _BLOCKING[kind + (1 if kind == _SYNC else 2)] += perf_counter_ns() - t0


def transfer(t: torch.Tensor, device) -> torch.Tensor:
    """`t.to(device)` (`device` None: `t` itself), counted where it blocks
    the host: a read from a CUDA device or an upload to one, of at least
    one element (an empty copy does not wait on the device)."""
    if device is None:
        return t
    device = torch.device(device)
    if t.device.type == "cuda":
        kind = _D2H if device.type != "cuda" else None
    else:
        kind = _H2D if device.type == "cuda" else None
    if kind is None or t.numel() == 0:
        return t.to(device)
    t0 = perf_counter_ns()
    out = t.to(device)
    _count(kind, t.numel() * t.element_size(), t0)
    return out


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t.cpu()`, counted."""
    return transfer(t, _CPU)


def device_sync():
    """`torch.cuda.synchronize()`, counted."""
    t0 = perf_counter_ns()
    torch.cuda.synchronize()
    _count(_SYNC, 0, t0)


def _profiler_range(name: str):
    """A profiler range named `name`: torch's low-cost form of
    `record_function`, a CPU range that puts no copy of itself on the
    device's timeline (under the profiler it costs a few microseconds where
    `record_function` costs tens, which skewed short spans' ranges)."""
    return torch._C._profiler._RecordFunctionFast(name)


class Span:
    """One span of a record. `counts` holds the counters that moved while
    it was open, as {name: delta}; `end_ns` is None while it is open."""

    __slots__ = ("name", "path", "parent", "start_ns", "end_ns", "counts",
                 "_at", "_range")

    def __init__(self, name: str, path: str, parent: int):
        self.name = name
        self.path = path
        self.parent = parent
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None
        self.counts: Dict[str, int] = {}
        self._at = None
        self._range = (_profiler_range(path)
                       if torch.autograd.profiler._is_profiler_enabled
                       else None)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def _enter(self, at: tuple, start_ns: Optional[int] = None):
        """Open with the counters `at`: the profiler's range, then the
        clock, so that the range holds the span."""
        self._at = at
        if self._range is not None:
            self._range.__enter__()
        self.start_ns = perf_counter_ns() if start_ns is None else start_ns

    def _exit_range(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def _close(self, end_ns: int, now: tuple):
        if now != self._at:
            self.counts = {k: b - a for k, a, b in zip(COUNTERS, self._at, now)
                           if b != a}
        self.end_ns = end_ns
        self._at = None


class ProveRecord:
    """One prove: its id, its seed and its spans, the root `prove` first,
    each after its parent."""

    __slots__ = ("prove_id", "seed", "spans")

    def __init__(self, prove_id: int, seed):
        self.prove_id = prove_id
        self.seed = seed
        self.spans: List[Span] = []

    @property
    def root(self) -> Span:
        return self.spans[0]

    def children(self, index: int = 0) -> List[Span]:
        return [s for s in self.spans if s.parent == index]

    def totals(self) -> Dict[str, int]:
        """The counters' deltas over the prove (so far, while it runs)."""
        root = self.root
        if root.end_ns is not None:
            return dict(root.counts)
        return {k: b - a for k, a, b in zip(COUNTERS, root._at, counters())
                if b != a}


def history() -> List[ProveRecord]:
    """The process's last `HISTORY_LEN` prove records, oldest first."""
    return list(_HISTORY)


def current() -> Optional["SpanRecorder"]:
    return getattr(_local, "recorder", None)


class _Open:
    __slots__ = ("recorder", "name")

    def __init__(self, recorder, name):
        self.recorder = recorder
        self.name = name

    def __enter__(self):
        self.recorder.begin(self.name)

    def __exit__(self, *exc):
        self.recorder.end()


_NOTHING = contextlib.nullcontext()


def span(name: str):
    """A context that records a child span of the innermost open span of
    the prove in progress on this thread; nothing without one."""
    recorder = getattr(_local, "recorder", None)
    return _NOTHING if recorder is None else _Open(recorder, name)


class SpanRecorder:
    """The record of one prove, as a context: entering opens the record
    and its root span `prove` and makes it the thread's current recorder;
    leaving ends every span still open and, unless the prove raised,
    appends the record to the history."""

    def __init__(self, device=None, seed=None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.record = ProveRecord(next(_prove_ids), seed)
        self.stages: Dict[str, float] = {}
        self.peak_bytes: Dict[str, int] = {}
        self._open: List[int] = []  # indices of the open spans, root first
        self._stage: Optional[int] = None
        self._outer = None

    def __enter__(self):
        self._outer = current()
        _local.recorder = self
        self.begin("prove")
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            while self._open:
                self.end()
            if exc_type is None:
                _HISTORY.append(self.record)
        finally:
            _local.recorder = self._outer
        return False

    def _new(self, name: str) -> Span:
        spans = self.record.spans
        if self._open:
            parent = self._open[-1]
            path = f"{spans[parent].path}/{name}"
        else:
            parent, path = -1, name
        span = Span(name, path, parent)
        spans.append(span)
        self._open.append(len(spans) - 1)
        return span

    def begin(self, name: str, start_ns: Optional[int] = None):
        """Open a child of the innermost open span (from `start_ns`, else
        now)."""
        self._new(name)._enter(counters(), start_ns)

    def end(self) -> int:
        """End the innermost open span; returns its end."""
        span = self.record.spans[self._open.pop()]
        end = perf_counter_ns()
        span._exit_range()
        span._close(end, counters())
        return end

    def stage(self, label: str):
        """End the open stage and open the stage `label` where it ended:
        one clock read and one counter snapshot end the one and start the
        other, between the two profiler ranges."""
        if self._stage is None:
            self.begin(label)
        else:
            self._sync_stage()
            prev = self.record.spans[self._open.pop()]
            nxt = self._new(label)
            at = counters()
            prev._exit_range()
            now = perf_counter_ns()
            nxt._enter(at, now)
            prev._close(now, at)
            self._account(prev)
        self._stage = len(self.record.spans) - 1

    def finish(self):
        """End the last stage."""
        self._sync_stage()
        self.end()
        self._account(self.record.spans[self._stage])
        self._stage = None

    def _sync_stage(self):
        assert self._open[-1] == self._stage, "a span is open past its stage"
        if self.cuda:
            self.begin("sync")
            device_sync()
            self.end()
            self.peak_bytes[self.record.spans[self._stage].name] = (
                torch.cuda.max_memory_allocated())

    def _account(self, stage: Span):
        self.stages[stage.name] = (self.stages.get(stage.name, 0.0)
                                   + stage.seconds)

    def total(self) -> float:
        return (perf_counter_ns() - self.record.root.start_ns) / 1e9

    def report(self, **derived) -> Dict:
        out = {
            "total_s": round(self.total(), 4),
            "stages_s": {k: round(v, 4) for k, v in self.stages.items()},
        }
        if self.cuda:
            out["peak_bytes_at_mark"] = dict(self.peak_bytes)
        out["prove_id"] = self.record.prove_id
        out["spans"] = self.record.spans
        out.update(derived)
        return out
