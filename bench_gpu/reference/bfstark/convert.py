"""Carrying u64 data between numpy and torch.

Torch has no usable unsigned 64-bit arithmetic on the CPU (add, shifts and
compares raise for `uint64`), so the port keeps every field element, digest
word and trace value as an `int64` tensor holding the same 64 bits. These
helpers are the bit-identical views between the two representations, the
only place where host u64 arrays enter or leave the port's tensors.
"""

from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 64) - 1


def to_i64(v: int) -> int:
    """Python int in [0, 2^64) -> the signed int64 with the same bits."""
    v &= MASK64
    return v - (1 << 64) if v >= (1 << 63) else v


def u64_to_tensor(arr, device=None) -> torch.Tensor:
    """u64 ndarray (or anything numpy turns into one) -> int64 tensor with
    identical bits, on `device`."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    t = torch.from_numpy(a.view(np.int64).copy())
    return t if device is None else t.to(device)


def tensor_to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> host u64 ndarray with identical bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)

