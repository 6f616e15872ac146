"""The prover's span recorder (`stark_brainfuck_tpu_torch/utils/metrics.py`)
on seeded CPU proves of a small program, resident and streamed: the proof
bytes stay the JAX package's; each prove adds one record with its seed and a
fresh id; the top-level spans are `stages_s`; children nest in their
parents; the launch counters' deltas add up to the record's totals and to
`last_metrics`' launch keys; `open_runs` counts the runs that openings
hash; `fri_round_s` has one entry a fold round; each
span is a profiler range only under the profiler; the benchmark's
readers of spans and stage times read these proves; and the counted
transfer helper counts CUDA tensors only."""

import gc
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import stark_brainfuck_tpu as J
import stark_brainfuck_tpu_torch as TP
from stark_brainfuck_tpu_torch import convert
from stark_brainfuck_tpu_torch.ops import blake2b as B
from stark_brainfuck_tpu_torch.ops import field as F
from stark_brainfuck_tpu_torch.ops import field_kernels as FK
from stark_brainfuck_tpu_torch.ops import fri_kernels as FR
from stark_brainfuck_tpu_torch.protocol import fri as tfri
from stark_brainfuck_tpu_torch.utils import metrics as M

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_gpu")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import cells  # noqa: E402

# FRI 4096 = device_commit_min = fri_host_min: device trees (plain torch
# BLAKE2b here), one device fold round (the plain fold), then the host tail
SOURCE, INPUT, SEED = "+" * 6 + "[->++<]", "", 11
SMALL = {"fri_host_min": 4096}
MODES = {"resident": dict(SMALL),
         "streamed": {**SMALL, "stream_min": 1, "stream_classes": 4}}
NEW_READERS = ("stage_s.openings", "stage_s.fri", "host_s.lde_tables",
               "host_busy_share", "syncs_per_prove",
               "program_launches_per_prove")
STAGE_READERS = {"resident": ("stage_s.lde", "stage_s.commit",
                              "stage_s.combination", "stage_s.open_fri"),
                 "streamed": ("stage_s.lde", "stage_s.commit",
                              "stage_s.reopen", "stage_s.combination",
                              "stage_s.open_fri")}
# the plain versions that stand in for a kernel on the CPU, and the counter
# a launch of that kernel bumps
STAND_INS = ((B, "blake2b_words_plain", B, "LAUNCHES"),
             (F, "add_plain", FK, "LAUNCHES_ELEMENTWISE"),
             (F, "sub_plain", FK, "LAUNCHES_ELEMENTWISE"),
             (F, "mul_plain", FK, "LAUNCHES_ELEMENTWISE"),
             (FR, "fold_plain", FR, "LAUNCHES_FOLD"))

_CACHE = {}


def _trace():
    program = J.VirtualMachine.compile(SOURCE)
    tr = J.VirtualMachine.simulate(program, INPUT)
    args = (tr["processor"], tr["memory"], tr["instruction"], tr["input"],
            tr["output"])
    return program, tr, args


def _make(pkg, program, tr, seed=SEED, **config):
    return pkg.BrainfuckStark(
        tr["processor"].shape[0], tr["memory"].shape[0], program, INPUT,
        tr["output_data"], pkg.StarkConfig(seed=seed, **config),
        **({} if pkg is J else {"device": "cpu"}))


def _counting(mp):
    """Each plain stand-in bumps its kernel's launch counter, as the kernel's
    launch does on the card, and each read of a tensor's words to the host
    counts as a read from the card."""
    for mod, name, counters, counter in STAND_INS:
        inner = getattr(mod, name)

        def wrapper(*a, _inner=inner, _c=counters, _n=counter, **kw):
            setattr(_c, _n, getattr(_c, _n) + 1)
            return _inner(*a, **kw)

        mp.setattr(mod, name, wrapper)

    def read(t, _inner=convert.to_host):
        t0 = time.perf_counter_ns()
        out = _inner(t)
        M._count(M._D2H, t.numel() * t.element_size(), t0)
        return out

    mp.setattr(convert, "to_host", read)


def _proved(mode):
    """One seeded prove of `mode` with the stand-ins counting, and the JAX
    package's bytes: computed once."""
    if mode not in _CACHE:
        program, tr, args = _trace()
        jax_proof = _make(J, program, tr, **MODES[mode]).prove(*args, xp=np)
        tb = _make(TP, program, tr, **MODES[mode])
        before = [r.prove_id for r in M.history()]
        with pytest.MonkeyPatch.context() as mp:
            _counting(mp)
            start = time.perf_counter()
            proof = tb.prove(*args)
            end = time.perf_counter()
        _CACHE[mode] = SimpleNamespace(
            stark=tb, proof=proof, jax_proof=jax_proof, before=before,
            record=M.history()[-1], metrics=tb.last_metrics,
            job=SimpleNamespace(seed=SEED, start=start, end=end,
                                stages=dict(tb.last_metrics["stages_s"])))
    return _CACHE[mode]


def _by_path(record):
    out = {}
    for s in record.spans:
        out.setdefault(s.path, []).append(s)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_proof_bytes_unchanged(mode):
    p = _proved(mode)
    assert p.proof == p.jax_proof
    assert p.stark.use_stream == (mode == "streamed")


@pytest.mark.parametrize("mode", list(MODES))
def test_one_record_a_prove_with_its_seed_and_a_fresh_id(mode):
    p = _proved(mode)
    r = p.record
    assert r.seed == SEED
    assert r.prove_id == p.metrics["prove_id"]
    assert all(r.prove_id > i for i in p.before)
    assert [x.prove_id for x in M.history()].count(r.prove_id) == 1
    assert p.metrics["spans"] is r.spans
    assert r.spans[0].path == "prove" and r.spans[0].parent == -1
    assert all(s.end_ns is not None for s in r.spans)
    # a second prove adds one record, with a new id
    program, tr, args = _trace()
    n = len(M.history())
    _make(TP, program, tr, seed=SEED + 1).prove(*args)
    assert len(M.history()) == min(n + 1, M.HISTORY_LEN)
    assert M.history()[-1].seed == SEED + 1
    assert M.history()[-1].prove_id > r.prove_id


@pytest.mark.parametrize("mode", list(MODES))
def test_top_level_spans_are_the_stages(mode):
    p = _proved(mode)
    top = p.record.children(0)
    stages = p.metrics["stages_s"]
    assert [s.name for s in top] == list(stages)
    for s in top:
        assert abs(s.seconds - stages[s.name]) <= max(0.01 * stages[s.name],
                                                      5e-5), s.name
    # the stages tile the prove: each starts where the one before ended
    assert all(a.end_ns == b.start_ns for a, b in zip(top, top[1:]))
    assert top[0].start_ns >= p.record.root.start_ns
    assert top[-1].end_ns <= p.record.root.end_ns


@pytest.mark.parametrize("mode", list(MODES))
def test_children_nest_in_their_parents(mode):
    p = _proved(mode)
    spans = p.record.spans
    for i, s in enumerate(spans[1:], 1):
        parent = spans[s.parent]
        assert s.parent < i
        assert s.path == f"{parent.path}/{s.name}"
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    paths = _by_path(p.record)
    a = "prove/stage_a (base coeffs)" if mode == "streamed" \
        else "prove/stage_a (base LDE)"
    for child in ("pad", "randomizer", "upload", "tables", "lde"):
        assert len(paths[f"{a}/{child}"]) == 1, child
    where = "streamed" if mode == "streamed" else "device"
    for tree in (f"base merkle ({where})", f"ext merkle ({where})",
                 "combination merkle (device)"):
        for child in ("commit", "root"):
            assert len(paths[f"prove/{tree}/{child}"]) == 1, (tree, child)
    for child in ("scan", "terminals"):
        assert len(paths[f"prove/extend (device scan)/{child}"]) == 1
    c = "prove/stage_c (quotients+combination)"
    assert len(paths[f"{c}/symbolic"]) == 1
    assert len(paths[f"{c}/combination"]) == 1
    classes = paths.get(f"{c}/combination/class", [])
    if mode == "streamed":
        assert len(classes) == p.metrics["stream_classes"] == 4
        for child in ("base", "ext"):
            assert len(paths[f"prove/reopen (streamed 2nd pass)/{child}"]) == 1
    else:
        assert classes == []
    # the openings and FRI lie inside the mark fri.prove, one after the other
    mark, = paths["prove/fri.prove"]
    opened, = paths["prove/fri.prove/open"]
    fri, = paths["prove/fri.prove/fri"]
    assert mark.start_ns <= opened.start_ns <= opened.end_ns <= fri.start_ns
    assert fri.end_ns <= mark.end_ns
    assert opened.start_ns - mark.start_ns < 0.01 * mark.seconds * 1e9
    assert len(paths["prove/fri.prove/fri/query"]) == 1
    # a few spans a prove, not one a query or a kernel
    assert len(spans) < 100


@pytest.mark.parametrize("mode", list(MODES))
def test_launch_counters_add_up(mode):
    p = _proved(mode)
    spans, totals = p.record.spans, p.record.totals()
    for counter in ("b1", "f1", "f5", "d2h", "d2h_bytes"):
        assert totals.get(counter, 0) > 0, counter
    for counter in M.COUNTERS:
        top = sum(s.counts.get(counter, 0) for s in p.record.children(0))
        assert top == totals.get(counter, 0), counter
        for i, s in enumerate(spans):
            inner = sum(c.counts.get(counter, 0) for c in p.record.children(i))
            assert 0 <= inner <= s.counts.get(counter, 0), (s.path, counter)
    for key, counter in (("blake2b_launches", "b1"), ("subntt_launches", "b2"),
                         ("twiddle_outer_launches", "b3"),
                         ("gl_elementwise_launches", "f1"),
                         ("xf_elementwise_launches", "f2"),
                         ("acc_group_launches", "f3"),
                         ("quotient_launches", "f4")):
        assert p.metrics[key] == totals.get(counter, 0), key


@pytest.mark.parametrize("mode", list(MODES))
def test_open_runs_counts_the_runs_the_openings_hash(mode):
    """`open_runs`: the runs hashed again on the device for openings, in
    last_metrics, in the record's totals and in the spans that open trees;
    no reader's sum of launches or blocking points holds it."""
    p = _proved(mode)
    totals = p.record.totals()
    assert p.metrics["open_runs"] == totals["open_runs"] > 0
    assert "open_runs" not in M.LAUNCH_COUNTERS + M.BLOCKING_COUNTERS
    paths = _by_path(p.record)
    where = (["prove/reopen (streamed 2nd pass)/base",
              "prove/reopen (streamed 2nd pass)/ext"]
             if mode == "streamed" else [])
    for path in where + ["prove/fri.prove/open/prefetch",
                         "prove/fri.prove/fri/query"]:
        span, = paths[path]
        assert span.counts.get("open_runs", 0) > 0, path


@pytest.mark.parametrize("mode", list(MODES))
def test_fri_round_s_has_one_entry_a_fold_round(mode):
    p = _proved(mode)
    fri = p.stark.fri
    rounds = [s for s in p.record.spans if s.name == "round"]
    assert len(rounds) == fri.num_rounds() - 1
    assert p.metrics["fri_round_s"] == [round(s.seconds, 4) for s in rounds]
    assert all(s.path == "prove/fri.prove/fri/round" for s in rounds)
    assert not hasattr(fri, "last_round_s")


def test_spans_are_profiler_ranges_only_under_the_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    program = J.VirtualMachine.compile("++++")
    tr = J.VirtualMachine.simulate(program, "")
    args = (tr["processor"], tr["memory"], tr["instruction"], tr["input"],
            tr["output"])

    def make():
        return TP.BrainfuckStark(
            tr["processor"].shape[0], tr["memory"].shape[0], program, "",
            tr["output_data"], TP.StarkConfig(seed=3), device="cpu")

    entered = []
    inner = M._profiler_range

    def counting(name):
        entered.append(name)
        return inner(name)

    monkeypatch.setattr(M, "_profiler_range", counting)
    plain = make().prove(*args)
    assert entered == []
    gc.disable()  # a collection inside a short span would skew its range
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tb = make()
            profiled = tb.prove(*args)
    finally:
        gc.enable()
    assert profiled == plain
    spans = tb.last_metrics["spans"]
    assert sorted(entered) == sorted(s.path for s in spans)
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append(
            (e.time_range.end - e.time_range.start) * 1e3)  # ns
    by_path = _by_path(M.history()[-1])
    for path, group in by_path.items():
        got = sorted(ranges.get(path, []))
        want = sorted(s.end_ns - s.start_ns for s in group)
        assert len(got) == len(want), path
        for g, w in zip(got, want):
            assert abs(g - w) <= max(0.05 * w, 50_000), (path, g, w)


def _ctx(jobs):
    return SimpleNamespace(jobs=jobs, profile=None, profiled=[],
                           setup_s=1.0, peak_bytes=0, seconds=1.0)


@pytest.mark.parametrize("mode", list(MODES))
def test_readers_read_the_proves(mode):
    p = _proved(mode)
    ctx = _ctx([p.job])
    for name in NEW_READERS + STAGE_READERS[mode]:
        value = cells.reader(name)(ctx)
        assert value is not None and value > 0, name
    assert 0 < cells.reader("host_busy_share")(ctx) < 100
    opened = cells.reader("stage_s.openings")(ctx)
    fri = cells.reader("stage_s.fri")(ctx)
    assert opened + fri <= cells.reader("stage_s.open_fri")(ctx) + 1e-4
    # another seed, or this seed outside the job's time: no record
    other = SimpleNamespace(seed=SEED + 10**9, start=p.job.start,
                            end=p.job.end, stages={})
    late = SimpleNamespace(seed=SEED, start=p.job.end + 1e6,
                           end=p.job.end + 2e6, stages={})
    for job in (other, late):
        for name in NEW_READERS:
            assert cells.reader(name)(_ctx([job])) is None, name


def test_readers_read_nothing_without_the_history(monkeypatch):
    p = _proved("resident")
    monkeypatch.delattr(M, "history")
    for name in NEW_READERS:
        assert cells.reader(name)(_ctx([p.job])) is None, name


class _StandIn:
    """A tensor that says it lives on a CUDA device."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.moved = []

    def to(self, device):
        self.moved.append(device)
        return self.t

    def numel(self):
        return self.t.numel()

    def element_size(self):
        return self.t.element_size()


def test_transfer_counts_cuda_tensors_only():
    before = M.counters()
    t = torch.arange(6, dtype=torch.int64)
    assert M.transfer(t, "cpu") is t
    assert M.to_host(t) is t
    assert M.transfer(t, None) is t
    assert M.counters() == before
    standin = _StandIn(torch.arange(5, dtype=torch.int64))
    assert M.to_host(standin) is standin.t
    assert standin.moved == [torch.device("cpu")]
    got = dict(zip(M.COUNTERS, (b - a for a, b in zip(before, M.counters()))))
    assert got["d2h"] == 1 and got["d2h_bytes"] == 40 and got["d2h_ns"] >= 0
    assert got["h2d"] == got["sync"] == 0
    assert sum(got[k] for k in M.LAUNCH_COUNTERS) == 0
    # an empty copy does not wait on the device: not counted
    before = M.counters()
    empty = _StandIn(torch.zeros(0, dtype=torch.int64))
    assert M.to_host(empty) is empty.t
    assert M.counters() == before


def test_a_span_outside_a_prove_records_nothing():
    n = len(M.history())
    with M.span("anything"):
        pass
    assert M.current() is None and len(M.history()) == n


def test_a_prove_that_raises_leaves_no_record():
    n, last = len(M.history()), M.history()[-1:]
    with pytest.raises(RuntimeError):
        with M.SpanRecorder("cpu", 5) as rec:
            rec.stage("stage")
            rec.begin("open")
            raise RuntimeError("stop")
    assert M.current() is None
    assert len(M.history()) == n and M.history()[-1:] == last
    assert all(s.end_ns is not None for s in rec.record.spans)


def test_fri_commit_outside_a_prove_records_no_rounds():
    fri = tfri.Fri(F.GENERATOR, F.primitive_nth_root(256), 256, 4, 2)
    codeword = torch.zeros((256, 3), dtype=torch.int64)
    from stark_brainfuck_tpu_torch.protocol.channel import ProofStream

    n = len(M.history())
    fri.commit(codeword, ProofStream(), on_device=False)
    assert len(M.history()) == n
