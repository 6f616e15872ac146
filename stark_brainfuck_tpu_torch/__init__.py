"""stark_brainfuck_tpu_torch — the Brainfuck STARK prover and verifier on
PyTorch and CUDA.

The port of the JAX package `stark_brainfuck_tpu` to NVIDIA GPUs: the
same modules under the same names (ops/, models/, protocol/, parallel/,
vm/, utils/), int64 tensors holding u64 bits in place of u64 arrays, and a
hand-written Hopper kernel for each TPU kernel on the path (csrc/). Seeded
proofs are byte-identical to the JAX package's. It runs the prover under
the native or the reference-pickle codec (interop/), resident and (native,
from `stream_min` up) streamed, on one device or, with `mesh_shape`, over
the ranks of a `torch.distributed` process group (parallel/), with the
DEBUG degree checks on request; ops/poly.py and ops/fastpoly.py hold the
polynomial toolbox; native/ holds the host runtime in C++ (the trace
recorder and the OpenMP Merkle engine, built with g++ at first use).
Modules of the JAX package with no counterpart, each with its reason in
the module that would have used it: `ops/limb.py` and `ops/mxu_ntt.py`
(ops/kernel_ntt.py), `utils/aot.py` (protocol/stark.py).
"""

from .config import StarkConfig
from .protocol.stark import BrainfuckStark
from .vm.machine import VirtualMachine

__all__ = ["StarkConfig", "VirtualMachine", "BrainfuckStark"]
__version__ = "0.1.0"
