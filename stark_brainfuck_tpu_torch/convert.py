"""Carrying u64 data between numpy and torch.

Torch has no usable unsigned 64-bit arithmetic on the CPU (add, shifts and
compares raise for `uint64`), so the port keeps every field element, digest
word and trace value as an `int64` tensor holding the same 64 bits. These
helpers are the bit-identical views between the two representations, the
only place where host u64 arrays enter or leave the port's tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .utils.metrics import to_host, transfer

MASK64 = (1 << 64) - 1


def to_i64(v: int) -> int:
    """Python int in [0, 2^64) -> the signed int64 with the same bits."""
    v &= MASK64
    return v - (1 << 64) if v >= (1 << 63) else v


def u64_to_tensor(arr, device=None) -> torch.Tensor:
    """u64 ndarray (or anything numpy turns into one) -> int64 tensor with
    identical bits, on `device`."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    return transfer(torch.from_numpy(a.view(np.int64).copy()), device)


def tensor_to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> host u64 ndarray with identical bits."""
    return to_host(t.detach()).contiguous().numpy().view(np.uint64)


def digest_planes_to_words(lo, hi, device=None) -> torch.Tensor:
    """The JAX package's digest form, two (n, 8) u32 planes of low and high
    halves, -> this package's (n, 8) int64 digest words."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return u64_to_tensor(lo | (hi << np.uint64(32)), device)


def digest_words_to_planes(words: torch.Tensor):
    """(n, 8) int64 digest words -> the (lo, hi) u32 planes of the JAX
    package."""
    w = tensor_to_u64(words)
    return (
        (w & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (w >> np.uint64(32)).astype(np.uint32),
    )


def blocks_to_global(blocks, axis: int = 0) -> np.ndarray:
    """Per-rank blocks of a sharded codeword (int64 tensors or u64 arrays,
    in rank order, split along `axis`) -> the one u64 array the JAX package
    holds for it: its sharded arrays are global, laid out as the blocks
    joined in rank order."""
    parts = [
        tensor_to_u64(b) if torch.is_tensor(b) else np.asarray(b, np.uint64)
        for b in blocks
    ]
    return np.concatenate(parts, axis=axis)


def groups_to_tensors(groups, device=None):
    """Coefficient groups of the streamed prover (u64 arrays, as the JAX
    package holds them) -> the tuple of int64 tensors `protocol/stream.py`
    takes, so both packages build their trees from the same groups."""
    return tuple(u64_to_tensor(np.asarray(g), device) for g in groups)


def trace_to_tensors(trace: Dict, device=None) -> Dict[str, torch.Tensor]:
    """The five matrices of `VirtualMachine.simulate` as int64 tensors."""
    return {
        k: u64_to_tensor(trace[k], device)
        for k in ("processor", "memory", "instruction", "input", "output")
    }


def config_from_fields(fields: Dict):
    """The port's StarkConfig from a field dict (e.g. `dataclasses.asdict`
    of the JAX package's config); fields the port does not know are an
    error, not silently dropped."""
    from .config import StarkConfig

    known = {f.name for f in dataclasses.fields(StarkConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown StarkConfig fields: {sorted(unknown)}")
    return StarkConfig(**fields)
