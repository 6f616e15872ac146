"""On the card: one short run of the first cell, correct, with every
end-to-end metric the cell reports. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

import bench_gpu_tiny as T


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "bench_gpu/run.py", "--workload",
         "sec2.counter-2e15", "--seed", "12345", "--seconds", "3",
         "--trace", "0"],
        cwd=T.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result
    assert {"prove_cycles_per_s", "job_s_p95", "setup_s"} <= \
        set(result["metrics"])
    assert result["device"]["platform"] == "gpu"
