"""The prover's configuration: the port's `StarkConfig` fields that change
what a prove computes, and the two sizes that choose where its trees are
built (no byte of a proof depends on those two)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class StarkConfig:
    # FRI / soundness parameters (the JAX package's defaults). The FRI last
    # codeword has 2 x expansion_factor values and caps the colinearity
    # checks there: security_level 160 needs log_expansion_factor 5, and at
    # 4 the most is 128
    log_expansion_factor: int = 2
    security_level: int = 2
    num_randomizers: int = 1

    # subgroup order from which all omicron/omega roots are derived
    order: int = 1 << 32

    # RNG: an int seed gives a deterministic prover (None: os.urandom)
    seed: Optional[int] = None

    # transcript codec: the native one (canonical fixed-width byte format)
    codec: str = "native"

    # commitments are device trees from this codeword length up, hashlib
    # trees below it
    device_commit_min: int = 4096

    # FRI rounds whose codeword is shorter than this finish on the host
    fri_host_min: int = 1 << 14

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
        if self.codec != "native":
            raise ValueError(f"this prover runs the native codec, not "
                             f"{self.codec!r}")
        return self
