"""One run of one cell: set-up, the measured window, the traced jobs, the
metrics, and the judgement of the window's proofs.

A job is what a user of the prover runs and waits on: the program's trace
recorded by `VirtualMachine.simulate`, a `BrainfuckStark` built for it, and
`prove`, which ends with the proof's bytes on the host. Jobs run in a
closed loop, one in flight. Set-up builds or loads the program's kernels
and runs one warm-up job at the cell's shapes (every job of a mix pads to
the same table heights and FRI domain); the window then starts jobs while
its time is under `seconds`, and every job that starts completes and
counts. With `trace`, the window's jobs give the stage times, and a few
jobs after it run under torch.profiler for the device's numbers.
"""

from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional

import cells
import generator
import judge as judging


@dataclass
class Job:
    index: int
    values: Dict[str, int]
    seed: int
    source: str
    input: str
    cycles: int  # processor-table rows before padding
    start: float
    end: float
    host_s: float  # simulate and the constructor
    domain: int
    classes: Optional[int]  # the streamed prover's class count, or None
    stages: Dict[str, float] = field(default_factory=dict)
    proof: bytes = b""


def run_job(P, spec, stark: dict, heights, device, mark=None) -> Job:
    """One job of the program `P` (the `stark_brainfuck_tpu_torch`
    package); `mark(name)` gives a context for each phase."""
    import contextlib

    import torch

    mark = mark or (lambda name: contextlib.nullcontext())
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    with mark("job.simulate"):
        program = P.VirtualMachine.compile(spec.source)
        trace = P.VirtualMachine.simulate(program, spec.input)
    with mark("job.construct"):
        prover = P.BrainfuckStark(
            trace["processor"].shape[0], trace["memory"].shape[0], program,
            spec.input, trace["output_data"],
            P.StarkConfig(seed=spec.seed, **stark), device=device,
        )
    t1 = time.perf_counter()
    got = [t.height for t in prover.tables]
    if heights is not None and got != list(heights):
        raise RuntimeError(f"job {spec.index} ({spec.values}): table heights "
                           f"{got}, the mix pads to {list(heights)}")
    with mark("job.prove"):
        proof = prover.prove(trace["processor"], trace["memory"],
                             trace["instruction"], trace["input"],
                             trace["output"])
        if cuda:
            torch.cuda.synchronize()
    t2 = time.perf_counter()
    metrics = getattr(prover, "last_metrics", {}) or {}
    return Job(
        index=spec.index, values=dict(spec.values), seed=spec.seed,
        source=spec.source, input=spec.input,
        cycles=int(trace["processor"].shape[0]), start=t0, end=t2,
        host_s=t1 - t0, domain=prover.fri.domain.length,
        classes=metrics.get("stream_classes"),
        stages=dict(metrics.get("stages_s", {})), proof=bytes(proof),
    )


def _profiled(P, stream, stark, heights, device, count):
    """`count` jobs under torch.profiler: (jobs, trace.Profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import devtrace

    torch.cuda.synchronize()
    jobs = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            jobs.append(run_job(P, stream.next(), stark, heights, device,
                                mark=record_function))
    return jobs, devtrace.reduce(prof.events(), [j.stages for j in jobs])


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device="cuda", started: Optional[float] = None, bench=None,
        here: str = cells.HERE, log=sys.stderr, program=None) -> dict:
    """The result of one run: {"correct", "attempted", "failed", "metrics",
    "device"[, "breakdown"], "checks"}. `started` is when the process
    started (set-up counts from there), `bench` the parsed BENCHMARK.json,
    `here` the folder holding configs/, traffic/ and metrics/, `program`
    the package that proves (stark_brainfuck_tpu_torch; a control puts
    another in its place)."""
    started = time.perf_counter() if started is None else started
    bench = bench if bench is not None else cells.load_benchmark()
    cell = cells.find_cell(bench, cell_name)
    config = cells.load_config(cell["config"], here)
    traffic = cells.load_traffic(cell["traffic"], here)
    counts = cells.job_counts(cell_name, config, here)
    stark, heights = config["stark"], traffic.get("heights")

    import torch

    if program is None:
        import stark_brainfuck_tpu_torch as program
    P = program

    cuda = torch.device(device).type == "cuda"
    bounds = generator.drawn_range(traffic)
    warm = run_job(P, generator.JobStream(traffic, seed, 1, bounds).next(),
                   stark, heights, device)
    del warm.proof
    stream = generator.JobStream(traffic, seed, 0, bounds)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    jobs: List[Job] = []
    failed = 0
    window_start = time.perf_counter()
    setup_s = window_start - started
    while time.perf_counter() - window_start < seconds:
        spec = stream.next()
        try:
            job = run_job(P, spec, stark, heights, device)
            if job.domain != warm.domain:
                raise RuntimeError(f"job {spec.index}: FRI domain "
                                   f"{job.domain}, set-up warmed "
                                   f"{warm.domain}")
            jobs.append(job)
        except Exception:  # a job that fails counts as failed, the run goes on
            failed += 1
            traceback.print_exc(file=log)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    profile, profiled = None, []
    t_profile = time.perf_counter()
    if trace and cuda:
        try:
            profiled, profile = _profiled(P, stream, stark, heights, device,
                                          counts["profile_jobs"])
        except Exception:
            failed += 1
            traceback.print_exc(file=log)

    ctx = SimpleNamespace(jobs=jobs, setup_s=setup_s, peak_bytes=peak,
                          profile=profile, profiled=profiled, config=config,
                          traffic=traffic, cell=cell, seconds=seconds)
    metrics = {}
    for m in cells.cell_metrics(bench, cell_name, trace):
        value = cells.reader(m["name"], here)(ctx) if jobs else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state is freed before the reference runs
    window = {"jobs": len(jobs), "failed": failed,
              "cycles": sum(j.cycles for j in jobs),
              "window_s": (jobs[-1].end - jobs[0].start) if jobs else 0.0,
              "domain": warm.domain, "classes": warm.classes,
              "job_s": [round(j.end - j.start, 4) for j in jobs],
              "host_s": [round(j.host_s, 4) for j in jobs]}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_judge = time.perf_counter()
    checks = judging.judge(jobs, stark, counts["reprove_jobs"], seed, device)
    window["profile_s"] = t_judge - t_profile
    window["judge_s"] = time.perf_counter() - t_judge
    # the reference's peak, apart from the window's
    window["judge_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                  if cuda else 0)
    result = {
        "correct": (failed == 0 and bool(jobs)
                    and all(c["ok"] for c in checks.values())),
        "attempted": len(jobs) + failed,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": int(cell.get("chips", 1)),
            "memory_peak_bytes": int(peak),
        },
    }
    if profile is not None:
        result["device"]["busy_s"] = profile.busy_s
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = profile.breakdown()
    result["window"] = window
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    return result
