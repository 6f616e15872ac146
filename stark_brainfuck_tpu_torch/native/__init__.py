"""The host runtime in C++, bound with ctypes: the Brainfuck trace recorder
(`vm.cpp`, used by `vm/machine.py`), the OpenMP BLAKE2b Merkle engine
(`hashing.cpp`, used by `protocol/merkle.py`) and FRI's host-tail fold
(`fri_host.cpp`, kernel F5's body, used by `ops/fri_kernels.py`).

Each source builds at first use with `g++ -O3 -shared -fPIC -fopenmp` into
`.torch_kernels/` at the repository root, one library per source keyed by
its content, through the same cache as the CUDA kernels
(`ops/cuda_build.py` `load_host`). A build that fails raises with g++'s
output: there is no python fallback to hide it. The recorder gives every
trace its own handle, so threads may simulate at once.
"""

from __future__ import annotations

import ctypes
import functools

from ..ops import cuda_build

_SIGNATURES = {
    "fri_host": {
        "fri_fold_host": ([ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_void_p], None),
    },
    "hashing": {
        "merkle_from_payloads": ([ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_size_t, ctypes.c_char_p], None),
    },
    "vm": {
        "vm_create": ([], ctypes.c_void_p),
        "vm_destroy": ([ctypes.c_void_p], None),
        "vm_simulate": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                         ctypes.c_void_p, ctypes.c_size_t], ctypes.c_int),
        **{f"vm_{m}_rows": ([ctypes.c_void_p], ctypes.c_size_t)
           for m in ("processor", "instruction", "memory", "input", "output")},
        "vm_fill": ([ctypes.c_void_p] * 6, None),
    },
}


@functools.cache
def _get(name: str) -> ctypes.CDLL:
    lib = cuda_build.load_host(name)
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def get_lib() -> ctypes.CDLL:
    """The hashing library (`hashing.cpp`), built if needed."""
    return _get("hashing")


def get_vm_lib() -> ctypes.CDLL:
    """The trace recorder (`vm.cpp`), built if needed."""
    return _get("vm")


def get_fri_lib() -> ctypes.CDLL:
    """FRI's host-tail fold (`fri_host.cpp`), built if needed."""
    return _get("fri_host")
