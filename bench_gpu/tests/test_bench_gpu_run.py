"""run.py without a card, and without the program beside it."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import bench_gpu_tiny as T


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bench_gpu/run.py", "--workload",
         "sec2.counter-2e15", "--seed", "3", "--seconds", "1",
         "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def _has_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except ValueError:
        return False


def test_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = _run(T.ROOT)
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    assert "CUDA" in out.stderr


def test_fails_with_the_card_hidden():
    out = _run(T.ROOT, env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not _has_result(out.stdout)


def test_fails_without_the_program(tmp_path):
    """A folder holding only BENCHMARK.json and the benchmark's files: the
    harness cannot import the program, and no result is printed."""
    shutil.copy(os.path.join(T.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(T.BENCH, tmp_path / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    here = str(tmp_path / "bench_gpu")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import harness\n"
            "harness.run('sec2.counter-2e15', 1, 0.1, False, device='cpu')\n"
            % here)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "stark_brainfuck_tpu_torch" in out.stderr
