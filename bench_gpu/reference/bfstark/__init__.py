"""bfstark — the plain reference prover of the benchmark.

A frozen copy of `stark_brainfuck_tpu_torch` as it stood at commit
bb772fbb3b48, cut to what a resident, single-device, native-codec prove
and its verifier run, with every operation on its plain torch form: the
field and extension-field arithmetic, BLAKE2b, the NTT, the extension scan,
the constraint evaluation, the weighted combination and the FRI fold run as
int64 torch programs on whatever device the caller gives, Merkle trees
below `device_commit_min` on hashlib, and the trace is recorded by the
python recorder. No kernel, compiled library or native code is reached.

Above the FRI domains that path holds on one card (`RESIDENT_MAX`), the
same prover proves in classes (`protocol/classes.py`, `ClassStark`): this
package's own code, not a copy of the program's streamed prover.

A seeded proof of the Brainfuck STARK is a determined byte string, the same
on every path of the port (resident or streamed, any NTT route, any class
count) and the same as the JAX package's: the benchmark holds each proof
the port makes to the bytes this copy makes from the same program, input
and seed. It is frozen so that no change to the program moves its
yardstick, and it imports nothing of the program.
"""

from .config import StarkConfig
from .protocol.stark import BrainfuckStark
from .vm.machine import VirtualMachine

__all__ = ["StarkConfig", "VirtualMachine", "BrainfuckStark"]
