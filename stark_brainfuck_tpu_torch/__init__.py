"""stark_brainfuck_tpu_torch — the Brainfuck STARK prover and verifier on
PyTorch and CUDA.

The port of the JAX package `stark_brainfuck_tpu` to NVIDIA GPUs: the
same modules under the same names (ops/, models/, protocol/, parallel/,
vm/, utils/), int64 tensors holding u64 bits in place of u64 arrays, and a
hand-written Hopper kernel for each TPU kernel on the path (csrc/). Seeded
proofs are byte-identical to the JAX package's. It runs the native-codec
prover, resident and (from `stream_min` up) streamed, on one device or,
with `mesh_shape`, over the ranks of a `torch.distributed` process group
(parallel/); see ROADMAP.md for what is still to come.
"""

from .config import StarkConfig
from .protocol.stark import BrainfuckStark
from .vm.machine import VirtualMachine

__all__ = ["StarkConfig", "VirtualMachine", "BrainfuckStark"]
__version__ = "0.1.0"
