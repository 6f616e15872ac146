"""Injectable randomness seam (a copy of the JAX package's `utils/rng.py`).

Every prover draw goes through one object, so a seeded prover replays
exactly: shake_256(seed ‖ counter) gives the same bytes, and therefore the
same proof, in both packages. Draws are host numpy u64 arrays; callers move
them to the device.
"""

from __future__ import annotations

import os
from hashlib import shake_256
from typing import Optional

import numpy as np

from ..ops.field import P

_U64 = np.uint64


def _host_mod_p_mul_add(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi·(2^32 - 1) + lo) mod p for hi < 2^8 and lo < p, on host u64."""
    with np.errstate(over="ignore"):
        t = hi * _U64(0xFFFFFFFF)  # < 2^40, exact
        s = t + lo
        wrapped = s < lo
        s = np.where(wrapped, s + _U64(0xFFFFFFFF), s)
        return np.where(s >= _U64(P), s - _U64(P), s)


class Rng:
    def __init__(self, seed: Optional[int] = None):
        self._counter = 0
        self._seed = None if seed is None else seed.to_bytes(16, "little")

    def bytes(self, n: int) -> bytes:
        if self._seed is None:
            return os.urandom(n)
        self._counter += 1
        return shake_256(
            self._seed + self._counter.to_bytes(8, "little")
        ).digest(n)

    def base_elements(self, shape) -> np.ndarray:
        n = int(np.prod(shape))
        return self._uniform_mod_p(n).reshape(shape)

    def x_element(self, chunk: int = 8) -> tuple:
        from ..ops.xfield import h_sample

        return h_sample(self.bytes(3 * chunk))

    def x_elements(self, shape) -> np.ndarray:
        n = int(np.prod(shape))
        return self._uniform_mod_p(3 * n).reshape(tuple(shape) + (3,))

    def _uniform_mod_p(self, n: int) -> np.ndarray:
        """n field elements from one bulk draw: 9 random bytes per element
        reduced via 2^64 ≡ 2^32 - 1 (mod p)."""
        raw = np.frombuffer(self.bytes(9 * n), dtype=np.uint8).reshape(n, 9)
        lo = raw[:, :8].copy().view("<u8").reshape(n)
        hi = raw[:, 8].astype(_U64)
        lo = np.where(lo >= _U64(P), lo - _U64(P), lo)
        return _host_mod_p_mul_add(hi, lo)
