"""Per-stage prover wall-clock marks.

Every prove records wall time per pipeline stage; `STARK_PROFILE=1` streams
the marks to stderr and the last run is at `BrainfuckStark.last_metrics`.
On a CUDA device each mark first synchronises the device, so a stage's
kernels are billed to that stage and not to whichever later stage first
waits on them, and records `torch.cuda.max_memory_allocated()` as it
stands at the mark: the first stage whose mark reaches the final value is
the one that holds the peak.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional

import torch


class StageTimer:
    def __init__(self, device=None, stream_to_stderr: Optional[bool] = None):
        if stream_to_stderr is None:
            stream_to_stderr = os.environ.get("STARK_PROFILE") is not None
        self.stream = stream_to_stderr
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.stages: Dict[str, float] = {}
        self.peak_bytes: Dict[str, int] = {}
        self._last = time.time()
        self._start = self._last

    def mark(self, label: str):
        """Record the time since the previous mark."""
        if self.cuda:
            torch.cuda.synchronize()
            self.peak_bytes[label] = torch.cuda.max_memory_allocated()
        now = time.time()
        dt = now - self._last
        self.stages[label] = self.stages.get(label, 0.0) + dt
        if self.stream:
            print(f"[prove] {label}: {dt:.2f}s", file=sys.stderr, flush=True)
        self._last = now

    def total(self) -> float:
        return time.time() - self._start

    def report(self, **derived) -> Dict:
        out = {
            "total_s": round(self.total(), 4),
            "stages_s": {k: round(v, 4) for k, v in self.stages.items()},
        }
        if self.cuda:
            out["peak_bytes_at_mark"] = dict(self.peak_bytes)
        out.update(derived)
        return out
