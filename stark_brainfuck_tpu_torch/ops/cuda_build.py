"""Building and loading the port's native libraries: the hand-written CUDA
kernels and the host runtime.

Every `csrc/<name>.cu` has a plain C interface. `build` compiles each one
with nvcc for `sm_90a` into `.torch_kernels/lib<name>-<key>.so` at the
repository root, keyed by the content of the source and of the headers
beside it (`csrc/*.cuh`) and by the compiler flags, so an unchanged source
is never rebuilt; several sources build in parallel,
one nvcc each, all started together. nvcc's report (`-Xptxas -v`: registers,
shared memory, spills per kernel) is kept beside each library as `.log`.
`build_host` does the same for the host runtime's C++ sources,
`native/<name>.cpp` (and the host harness of kernel F4 there), with g++ (`-O3 -fopenmp`) into
`.torch_kernels/libnative_<name>-<key>.so`. `load` and `load_host` return
a library as a ctypes handle, building it first if needed, once per
process and under one lock, so threads that first need a library together
build and load it once. A failed build raises with the compiler's output;
nothing falls back. Nothing here runs at import: this module is imported
on machines without nvcc, where only the plain torch versions of the
kernels run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Dict, Iterable, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# the host compiler; no -march=native, so a library runs on any x86-64 host
GXX = "g++"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-fopenmp"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _sources(directory: str, suffix: str) -> List[str]:
    return sorted(
        name[: -len(suffix)] for name in os.listdir(directory)
        if name.endswith(suffix)
    )


def kernel_names():
    """Names of every kernel source, `csrc/<name>.cu`."""
    return _sources(CSRC_DIR, ".cu")


def host_names():
    """Names of every host runtime source, `native/<name>.cpp`."""
    return _sources(NATIVE_DIR, ".cpp")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(source: str, flags: List[str], stem: str) -> str:
    """Where the library of `source` lives for the current content of the
    source and of every header it may include (`*.cuh` beside it and in
    `csrc/`, which the host harness of kernel F4 includes): a changed
    header must not reuse a stale library."""
    headers = []
    for directory in dict.fromkeys([os.path.dirname(source), CSRC_DIR]):
        headers += [os.path.join(directory, name)
                    for name in sorted(os.listdir(directory))
                    if name.endswith(".cuh")]
    key = hashlib.blake2b(digest_size=8)
    for path in [source, *headers]:
        with open(path, "rb") as fh:
            key.update(fh.read())
    key.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{key.hexdigest()}.so")


def _build(sources: Dict[str, str], prefix: str,
           compiler: Callable[[], str], flags: List[str]) -> Dict[str, str]:
    """Compile every source of {name: source path} that has no library for
    its current content yet (`lib<prefix><name>-<key>.so`), one compiler
    process each, all started together; returns {name: library path}.
    Raises with the compiler's output if any build fails or the compiler
    cannot start."""
    out = {n: _library_path(src, flags, prefix + n)
           for n, src in sources.items()}
    todo = {n: p for n, p in out.items() if not os.path.exists(p)}
    if not todo:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tool = compiler()
    running, failed = [], []
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.Popen(
                [tool, *flags, "-o", tmp, sources[name]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        except OSError as exc:
            os.unlink(tmp)
            failed.append(f"{os.path.basename(sources[name])} ({tool} "
                          f"did not start: {exc})")
            continue
        running.append((name, path, tmp, proc))
    for name, path, tmp, proc in running:
        report, _ = proc.communicate()
        with open(path[:-3] + ".log", "w") as fh:
            fh.write(report)
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            failed.append(f"{os.path.basename(sources[name])} ({tool} exit "
                          f"{proc.returncode}):\n{report}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failed:
        raise RuntimeError("native build failed: " + "\n".join(failed))
    return out


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernel sources (all of them by default) that have
    no library for their current content yet; returns {name: library path}.
    Raises with nvcc's output if any build fails."""
    names = kernel_names() if names is None else list(names)
    return _build({n: os.path.join(CSRC_DIR, f"{n}.cu") for n in names},
                  "", _nvcc, NVCC_FLAGS)


def build_host(names: Optional[Iterable[str]] = None,
               defines: Iterable[str] = ()) -> Dict[str, str]:
    """`build` for the host runtime's C++ sources, `native/<name>.cpp`, with
    g++; `defines` (`NAME=value`) become `-D` flags, and part of the key.
    Raises with g++'s output if any build fails."""
    names = host_names() if names is None else list(names)
    return _build({n: os.path.join(NATIVE_DIR, f"{n}.cpp") for n in names},
                  "native_", lambda: GXX,
                  GXX_FLAGS + [f"-D{d}" for d in defines])


def _load(key: str, build_one: Callable[[], str]) -> ctypes.CDLL:
    with _LOCK:
        if key not in _LIBS:
            _LIBS[key] = ctypes.CDLL(build_one())
        return _LIBS[key]


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`'s library, built if needed and
    loaded once per process."""
    return _load(name, lambda: build([name])[name])


def load_host(name: str) -> ctypes.CDLL:
    """The ctypes handle of `native/<name>.cpp`'s library, built with g++ if
    needed and loaded once per process."""
    return _load(f"native/{name}", lambda: build_host([name])[name])
