"""Building and loading the port's hand-written CUDA kernels.

Every `csrc/<name>.cu` has a plain C interface. `build` compiles each one
with nvcc for `sm_90a` into `.torch_kernels/lib<name>-<key>.so` at the
repository root, keyed by the source's content and the compiler flags, so
an unchanged source is never rebuilt; several sources build in parallel,
one nvcc each, all started together. nvcc's report (`-Xptxas -v`: registers,
shared memory, spills per kernel) is kept beside each library as `.log`.
`load` returns the library as a ctypes handle, building it first if needed.
Nothing here runs at import: this module is imported on machines without
nvcc, where only the plain torch versions of the kernels run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def kernel_names():
    """Names of every kernel source, `csrc/<name>.cu`."""
    return sorted(
        name[:-3] for name in os.listdir(CSRC_DIR) if name.endswith(".cu")
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> str:
    """Where the library of `csrc/<name>.cu` lives for its current content."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as fh:
        key = hashlib.blake2b(
            fh.read() + " ".join(NVCC_FLAGS).encode(), digest_size=8
        ).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{key}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernel sources (all of them by default) that have
    no library for their current content yet; returns {name: library path}.
    Raises with nvcc's output if any build fails."""
    names = kernel_names() if names is None else list(names)
    out = {name: _library_path(name) for name in names}
    todo = {n: p for n, p in out.items() if not os.path.exists(p)}
    if not todo:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC_DIR, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in running:
        report, _ = proc.communicate()
        with open(path[:-3] + ".log", "w") as fh:
            fh.write(report)
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{report}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`'s library, built if needed and
    loaded once per process."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build([name])[name])
    return _LIBS[name]
