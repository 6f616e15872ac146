"""The end-of-run check on loaded modules compares whole top-level names."""

import subprocess
import sys

import bench_gpu_tiny as T
import guard


def test_forbidden_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "stark_brainfuck_tpu", "stark_brainfuck_tpu.ops.field",
             "stark_brainfuck_tpu_torch", "stark_brainfuck_tpu_torch.ops",
             "jaxtyping", "numpy", "torch"]
    assert guard.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "stark_brainfuck_tpu", "stark_brainfuck_tpu.ops.field"])


def test_a_run_loads_nothing_forbidden():
    """The harness, the reference and the program in one process load no
    JAX and not the JAX package."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import harness, judge, control, devtrace, card, generator\n"
            "import stark_brainfuck_tpu_torch\n"
            "from reference import bfstark\n"
            "import guard; bad = guard.forbidden_modules()\n"
            "print(bad); sys.exit(1 if bad else 0)\n") % (T.ROOT, T.BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
