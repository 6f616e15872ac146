"""The prover's spans on the card, for one benchmark cell's jobs.

    python3 scripts/trace_spans.py --workload sec2.counter-2e15 --seed N \
        --out DIR [--jobs 6] [--profiled 2]

After one warm-up job at the cell's shapes it measures, in this order:

  - `span_cost`: the recorder with no profiler, a loop of empty spans
    inside one record (microseconds a span);
  - `plain`: `--jobs` jobs as the benchmark runs them: each job's time,
    spans a prove, the benchmark's readers of the program's spans and
    counters over these jobs, and the host's seconds a prove by span (all
    of it and its own, without its children's);
  - `sync_debug`: one prove under `torch.cuda.set_sync_debug_mode("warn")`:
    the synchronising calls torch warned about against the record's
    counted blocking points, with the lines (and python stacks) of the
    warnings that no counted call made and the lines of the counted calls
    that drew no warning;
  - `profiled`: `--profiled` jobs under torch.profiler (CPU and CUDA), as
    the benchmark's traced jobs run: each job's time against the plain
    ones', and the device's idle gaps inside the proves, each piece put
    down to the innermost program range open over it, from the trace's own
    ranges (`prove/...`), and the device's events named like a program
    range (annotation copies, if the profiler makes any).

One JSON line a part on standard output; all of it in
`<out>/trace_spans_<workload>.json`. `--device cpu` with `--traffic FILE`
(a small mix) checks the script on a CPU, without the synchronise count.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback
import warnings
from collections import defaultdict
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_gpu")
sys.path[:0] = [ROOT, BENCH]


def emit(out, part, **kw):
    out[part] = kw
    print(json.dumps({"part": part, **kw}), flush=True)


def span_cost(M, n=20000):
    """Microseconds an empty span costs with no profiler."""
    with M.SpanRecorder("cpu", None) as rec:
        rec.stage("loop")
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with M.span("x"):
                pass
        dt = time.perf_counter_ns() - t0
        rec.finish()
    return dt / n / 1e3


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_by_span(events, is_annotation):
    """Idle gaps of the device inside each `job.prove` range, put down to the
    innermost program range over each piece; and the device events that
    carry a program range's name."""
    from torch.autograd import DeviceType

    device, ranges, proves, copies = [], [], [], 0
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("prove"):
                copies += 1
            if not is_annotation(e) and not e.name.startswith("prove"):
                device.append((a, b))
        elif e.name == "job.prove":
            proves.append((a, b))
        elif e.name == "prove" or e.name.startswith("prove/"):
            ranges.append((a, b, e.name))
    busy = union(device)
    idle = defaultdict(float)
    busy_in, span_in = 0.0, 0.0
    for lo, hi in proves:
        span_in += hi - lo
        gaps, t = [], lo
        for a, b in busy:
            if b <= lo or a >= hi:
                continue
            a, b = max(a, lo), min(b, hi)
            busy_in += b - a
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        inside = [r for r in ranges if r[1] > lo and r[0] < hi]
        for ga, gb in gaps:
            cuts = sorted({ga, gb} | {x for r in inside for x in r[:2]
                                      if ga < x < gb})
            for a, b in zip(cuts, cuts[1:]):
                over = [r for r in inside if r[0] <= a and r[1] >= b]
                name = (max(over, key=lambda r: r[2].count("/"))[2]
                        if over else "(no program range)")
                idle[name] += (b - a) / 1e6
    return {
        "proves": len(proves),
        "prove_s": span_in / 1e6,
        "device_busy_s": busy_in / 1e6,
        "idle_share": 1 - busy_in / span_in if span_in else None,
        "idle_s_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "device_events_named_prove": copies,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--profiled", type=int, default=2)
    ap.add_argument("--out", required=True, help="folder for the JSON")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traffic", help="a mix's file in place of the cell's")
    args = ap.parse_args(argv)

    import cells

    cell = cells.find_cell(cells.load_benchmark(ROOT), args.workload)
    config = cells.load_config(cell["config"])
    if config.get("host_threads") is not None:
        os.environ["OMP_NUM_THREADS"] = str(int(config["host_threads"]))

    import torch

    if config.get("host_threads") is not None:
        torch.set_num_threads(int(config["host_threads"]))
    dev = args.device
    cuda = dev == "cuda"
    if cuda and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    from torch.profiler import ProfilerActivity, profile, record_function

    import devtrace
    import generator
    import harness
    import stark_brainfuck_tpu_torch as P
    from stark_brainfuck_tpu_torch.utils import metrics as M

    if args.traffic:
        with open(args.traffic) as fh:
            traffic = json.load(fh)
    else:
        traffic = cells.load_traffic(cell["traffic"])
    stark, heights = config["stark"], traffic.get("heights")
    bounds = generator.drawn_range(traffic)
    stream = generator.JobStream(traffic, args.seed, 0, bounds)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0) if cuda else dev,
           "torch": torch.__version__}
    harness.run_job(P, generator.JobStream(traffic, args.seed, 1,
                                           bounds).next(),
                    stark, heights, dev)
    sync()

    emit(out, "span_cost", us_a_span=span_cost(M))

    jobs = [harness.run_job(P, stream.next(), stark, heights, dev)
            for _ in range(args.jobs)]
    ctx = SimpleNamespace(jobs=jobs)
    records = {r.seed: r for r in M.history()}
    names = ("stage_s.openings", "stage_s.fri", "stage_s.open_fri",
             "host_s.lde_tables", "host_busy_share", "syncs_per_prove",
             "program_launches_per_prove", "stage_s.lde", "stage_s.commit",
             "stage_s.reopen", "stage_s.combination")
    counts = defaultdict(list)
    for j in jobs:
        for k, v in records[j.seed].totals().items():
            counts[k].append(v)
    by_path, own = defaultdict(float), defaultdict(float)
    for j in jobs:
        spans = records[j.seed].spans
        for i, sp in enumerate(spans):
            by_path[sp.path] += sp.seconds / len(jobs)
            own[sp.path] += (sp.seconds - sum(c.seconds for c in spans
                                              if c.parent == i)) / len(jobs)
    top = sorted(own, key=lambda k: -own[k])[:30]
    emit(out, "plain",
         job_s=[round(j.end - j.start, 4) for j in jobs],
         host_s_by_span={k: [round(by_path[k], 5), round(own[k], 5)]
                         for k in top},
         spans_a_prove=[len(records[j.seed].spans) for j in jobs],
         metrics={n: cells.reader(n)(ctx) for n in names},
         counters_median={k: statistics.median(v) for k, v in counts.items()})

    if cuda:
        spec = stream.next()
        program = P.VirtualMachine.compile(spec.source)
        trace = P.VirtualMachine.simulate(program, spec.input)
        prover = P.BrainfuckStark(
            trace["processor"].shape[0], trace["memory"].shape[0], program,
            spec.input, trace["output_data"],
            P.StarkConfig(seed=spec.seed, **stark), device=dev)
        torch.cuda.synchronize()
        unwarned = defaultdict(int)  # counted calls torch did not warn at
        count = M._count

        def counting(kind, nbytes, t0):
            # a counted call's warning comes from metrics.py (a transfer) or
            # torch.cuda (device_sync) and is the newest one caught
            warned = caught and caught[-1] is not seen[0] and (
                caught[-1].filename.endswith(("metrics.py", "__init__.py")))
            seen[0] = caught[-1] if caught else None
            if not warned:
                f = sys._getframe(1)
                while f.f_code.co_filename.endswith(("metrics.py",
                                                     "convert.py")):
                    f = f.f_back
                where = os.path.relpath(f.f_code.co_filename, ROOT)
                name = {M._SYNC: "sync", M._D2H: "d2h", M._H2D: "h2d"}[kind]
                unwarned[f"{name} {nbytes} B at {where}:{f.f_lineno}"] += 1
            count(kind, nbytes, t0)

        seen = [None]
        caught = []  # each warning, with the python stack that drew it

        def keep(message, category, filename, lineno, file=None, line=None):
            caught.append(SimpleNamespace(
                message=message, filename=filename, lineno=lineno,
                stack=[f"{os.path.relpath(fs.filename, ROOT)}:{fs.lineno}"
                       for fs in traceback.extract_stack()[-9:-1]]))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = keep
            torch.cuda.set_sync_debug_mode("warn")
            M._count = counting
            try:
                prover.prove(trace["processor"], trace["memory"],
                             trace["instruction"], trace["input"],
                             trace["output"])
            finally:
                torch.cuda.set_sync_debug_mode(0)
                M._count = count
        torch.cuda.synchronize()
        sites, stacks = defaultdict(int), {}
        for w in caught:
            if "synchroniz" in str(w.message):
                where = os.path.relpath(w.filename, ROOT)
                sites[f"{where}:{w.lineno}"] += 1
                if not w.filename.endswith("metrics.py"):
                    stacks.setdefault(f"{where}:{w.lineno}", w.stack)
        record = M.history()[-1]
        totals = record.totals()
        emit(out, "sync_debug", warned=sum(sites.values()),
             counted={k: totals.get(k, 0) for k in ("sync", "d2h", "h2d")},
             counted_sum=sum(totals.get(k, 0)
                             for k in ("sync", "d2h", "h2d")),
             sites=dict(sorted(sites.items(), key=lambda kv: -kv[1])),
             counted_unwarned=dict(unwarned),
             stacks_of_other_sites=stacks)

    profiled = []
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(args.profiled):
            profiled.append(harness.run_job(P, stream.next(), stark, heights,
                                            dev, mark=record_function))
    reduced = devtrace.reduce(prof.events(), [j.stages for j in profiled])
    plain = [j.end - j.start for j in jobs]
    emit(out, "profiled",
         job_s=[round(j.end - j.start, 4) for j in profiled],
         plain_job_s_median=statistics.median(plain),
         devtrace={"idle_share": 1 - reduced.busy_s / reduced.window_s,
                   "kernels_a_job": reduced.kernels / reduced.jobs,
                   "idle_gaps": reduced.breakdown()["idle_gaps"]},
         **idle_by_span(prof.events(), devtrace._is_annotation))

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"trace_spans_{args.workload}.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
