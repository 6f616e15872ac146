"""Whole jobs under torch.profiler, reduced to what the device did.

The harness marks each job's phases with `record_function` (`job.simulate`,
`job.construct`, `job.prove`). From the trace this takes the device's
events (kernels, copies and fills), their union on the device's timeline
(the busy time), the kernels launched, the device time by operation name,
and the idle gaps between device events, each put down to what the host was
doing: the job phase it falls in and, within a prove, the prover's stage,
placed on the timeline from the stage times the prover reports
(`last_metrics["stages_s"]`, marks in order from the prove's start).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

PHASES = ("job.simulate", "job.construct", "job.prove")


@dataclass
class Profile:
    jobs: int
    window_s: float  # first job's start to last job's end
    busy_s: float  # union of the device events' intervals
    kernels: int  # kernel launches (copies and fills left out)
    device_s_by_name: Dict[str, float] = field(default_factory=dict)
    idle_s_by_host: Dict[str, float] = field(default_factory=dict)

    def device_s(self, names: Sequence[str]) -> float:
        """Device time of the operations whose name holds any of
        `names`."""
        return sum(s for k, s in self.device_s_by_name.items()
                   if any(n in k for n in names))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by short name) and
        the idle time by what the host was doing, the largest first."""
        def largest(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        ops: Dict[str, float] = defaultdict(float)
        for k, v in self.device_s_by_name.items():
            ops[short_name(k)] += v
        return {"device_ops": largest(ops),
                "idle_gaps": largest(self.idle_s_by_host)}


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _is_annotation(e) -> bool:
    """The device-side copy of a host `record_function` range, which the
    profiler puts on the device's timeline: no operation of the device."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name in PHASES


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: `void at::native::foo<...>(...)` -> `at::native::foo`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if depth == 0 and ch == "(" and out and "".join(out).strip():
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(events, stages: Sequence[Dict[str, float]]) -> Profile:
    """A Profile from a profiler's `events()` over whole jobs; `stages`
    holds each profiled prove's `stages_s`, in order."""
    from torch.autograd import DeviceType

    phases = defaultdict(list)  # name -> [(start_us, end_us)] in order
    device = []
    by_name: Dict[str, float] = defaultdict(float)
    kernels = 0
    for e in events:
        if e.device_type == DeviceType.CUDA and not _is_annotation(e):
            a, b = e.time_range.start, e.time_range.end
            device.append((a, b))
            by_name[e.name] += (b - a) / 1e6
            if not _is_copy(e.name):
                kernels += 1
        elif e.device_type == DeviceType.CPU and e.name in PHASES:
            phases[e.name].append((e.time_range.start, e.time_range.end))
    spans = [s for p in PHASES for s in phases[p]]
    if not spans:
        raise ValueError("the trace holds no job")
    lo = min(a for a, _ in spans)
    hi = max(b for _, b in spans)
    busy = _union([(max(a, lo), min(b, hi)) for a, b in device
                   if b > lo and a < hi])

    # host labels: every phase span, and the prove spans cut into stages
    labels: List[Tuple[float, float, str]] = []
    for name in ("job.simulate", "job.construct"):
        labels += [(a, b, name) for a, b in phases[name]]
    for (a, b), st in zip(phases["job.prove"], stages):
        t = a
        for stage, secs in st.items():
            labels.append((t, min(t + secs * 1e6, b), f"prove: {stage}"))
            t += secs * 1e6
        if t < b:
            labels.append((t, b, "prove: after the last mark"))
    labels.sort()

    idle: Dict[str, float] = defaultdict(float)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    for ga, gb in gaps:
        covered = ga
        for la, lb, name in labels:
            if lb <= ga or la >= gb:
                continue
            a, b = max(la, covered), min(lb, gb)
            if b > a:
                idle[name] += (b - a) / 1e6
                covered = b
        if gb > covered:
            idle["between jobs"] += (gb - covered) / 1e6

    return Profile(
        jobs=len(phases["job.prove"]),
        window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernels=kernels,
        device_s_by_name=dict(by_name),
        idle_s_by_host=dict(idle),
    )
