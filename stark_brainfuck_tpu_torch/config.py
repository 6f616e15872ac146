"""Framework configuration.

The same fields as the JAX package's `StarkConfig`, so a configuration
carries across unchanged (`convert.config_from_fields`). This package runs
the native-codec prover, resident below `stream_min` and streamed from it
up, on one device or (resident only) over the ranks of a mesh; each option
outside that (the reference codec, the degree checks) raises
`NotImplementedError` naming the ROADMAP item that will bring it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class StarkConfig:
    # FRI / soundness parameters
    log_expansion_factor: int = 2
    security_level: int = 2
    num_randomizers: int = 1

    # subgroup order from which all omicron/omega roots are derived
    order: int = 1 << 32

    # RNG: None -> os.urandom; an int seed gives a deterministic prover
    seed: Optional[int] = None

    # transcript codec: only "native" here
    codec: str = "native"

    # mesh for sharded proving, e.g. (("shard", 4),): the product of the
    # sizes is the number of ranks, which must be the world size of the
    # initialised torch.distributed process group (one process per rank,
    # parallel/multihost.py); None or one rank is the single-device prover
    mesh_shape: Optional[Tuple[Tuple[str, int], ...]] = None

    # commitments (Merkle leaves + tree levels) are built on the device
    # from this codeword length up; below it the hashlib host trees are used
    device_commit_min: int = 4096

    # FRI rounds whose codeword is shorter than this finish on the host
    fri_host_min: int = 1 << 14

    # FRI domains >= stream_min take the streamed prover: codewords are
    # evaluated and committed in `stream_classes` strided classes and never
    # held whole (protocol/stream.py)
    stream_min: int = 1 << 22
    stream_classes: int = 32

    # where seeded streamed proves keep their stage checkpoints
    # (utils/checkpoint.py); None keeps none
    checkpoint_dir: Optional[str] = None

    # forward-LDE NTT: "auto" and "u64" run the u64 butterfly network (as
    # the JAX package resolves "auto"); "mxu" runs the four-step transform
    # on kernels B2/B3 (ops/kernel_ntt.py, csrc/ntt.cu), the port of the JAX
    # package's int8-limb MXU path. mxu_ntt_min is accepted and unused, as
    # there.
    ntt_backend: str = "auto"
    mxu_ntt_min: int = 1 << 14

    # opt-in quotient degree checks (the JAX package's DEBUG mode); not
    # ported yet, so the default ignores the DEBUG environment variable
    debug_degree_checks: bool = False

    @property
    def expansion_factor(self) -> int:
        return 1 << self.log_expansion_factor

    @property
    def num_colinearity_checks(self) -> int:
        return self.security_level // self.log_expansion_factor

    def validate(self):
        assert self.expansion_factor >= 4, "expansion factor must be >= 4"
        assert (
            self.num_colinearity_checks * self.log_expansion_factor
            >= self.security_level
        ), "colinearity checks x log expansion must cover security level"
        ranks = 1
        for _, size in self.mesh_shape or ():
            ranks *= int(size)
        if ranks < 1 or ranks & (ranks - 1):
            raise ValueError(
                f"mesh_shape {self.mesh_shape!r}: the number of ranks must "
                f"be a power of two (blocks of a power-of-two domain)"
            )
        if self.codec == "ref":
            raise NotImplementedError(
                "codec='ref': the reference-pickle codec is ROADMAP Queue A "
                "item 9"
            )
        if self.codec != "native":
            raise ValueError(f"unknown codec {self.codec!r}")
        if self.ntt_backend not in ("auto", "u64", "mxu"):
            raise ValueError(f"unknown ntt_backend {self.ntt_backend!r}")
        if self.debug_degree_checks:
            raise NotImplementedError(
                "debug_degree_checks: ROADMAP Queue A item 10"
            )
        return self
