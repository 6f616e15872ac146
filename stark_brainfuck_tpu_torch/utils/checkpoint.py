"""Checkpoint and resume for long proving runs.

Both ends of the pipeline persist:

  - the recorded execution trace (the expensive VM replay of long
    programs) as an .npz of the five matrices;
  - finished proofs, keyed by a digest of (program, input, output, config),
    so a re-run skips proving entirely.

Seeded streamed proves resume at stage granularity besides: the streamed
base and extension commitment passes persist their accumulated class-level
digest array per (claim, stage). A killed run derives the cheap
deterministic state again (trace, rng draws, coefficient groups) and skips
the committed stages, to a byte-identical proof. Unseeded runs draw fresh
randomness, so their commitments are never written or reused.

The stage files are this package's own: (S, 8) int64 digest words and the
package's code hash, under a name of their own (`commit_torch_*`). The JAX
package keys a claim alike and keeps u32 limb planes under its own code
hash in `commit_*`: in a shared directory neither package meets the other's
files. A file written by another version of this code is removed and never
resumed.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

TRACE_KEYS = ("processor", "memory", "instruction", "input", "output")


@functools.lru_cache(maxsize=None)
def package_code_hash() -> str:
    """Content hash of every source file of the package (each .py and each
    file under csrc/) and the torch version: any edit must invalidate the
    stage checkpoints, whose validity cannot be scoped to some modules."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for root, dirs, files in os.walk(pkg):
        dirs.sort()
        in_csrc = os.path.basename(root) == "csrc"
        for fname in sorted(files):
            if not (fname.endswith(".py") or in_csrc):
                continue
            path = os.path.join(root, fname)
            h.update(os.path.relpath(path, pkg).encode())
            with open(path, "rb") as fh:
                h.update(hashlib.sha256(fh.read()).digest())
    h.update(torch.__version__.encode())
    return h.hexdigest()[:16]


def trace_key(program, input_data: str = "") -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(json.dumps(list(program)).encode())
    h.update(input_data.encode())
    return h.hexdigest()


def save_trace(directory: str, trace: Dict[str, np.ndarray], program,
               input_data: str = "") -> str:
    os.makedirs(directory, exist_ok=True)
    key = trace_key(program, input_data)
    path = os.path.join(directory, f"trace_{key}.npz")
    np.savez_compressed(
        path,
        **{k: np.asarray(trace[k], dtype=np.uint64) for k in TRACE_KEYS},
        output_data=np.frombuffer(
            trace.get("output_data", "").encode("latin-1"), dtype=np.uint8
        ),
    )
    return path


def load_trace(directory: str, program, input_data: str = "") -> Optional[Dict]:
    path = os.path.join(directory, f"trace_{trace_key(program, input_data)}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        out = {k: data[k] for k in TRACE_KEYS}
        out["output_data"] = data["output_data"].tobytes().decode("latin-1")
    return out


def simulate_cached(program, input_data: str = "", directory: str = ".stark_cache"):
    """VirtualMachine.simulate with trace checkpointing."""
    from ..vm.machine import VirtualMachine

    cached = load_trace(directory, program, input_data)
    if cached is not None:
        return cached
    trace = VirtualMachine.simulate(program, input_data)
    save_trace(directory, trace, program, input_data)
    return trace


def proof_key(program, input_data: str, output_data: str, config) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(json.dumps(list(program)).encode())
    h.update(input_data.encode())
    h.update(output_data.encode())
    h.update(repr(config).encode())
    return h.hexdigest()


def _commit_path(directory: str, key: str, tag: str) -> str:
    return os.path.join(directory, f"commit_torch_{key}_{tag}.npz")


def save_commit_stage(directory: str, key: str, tag: str, digests) -> str:
    """Persist a streamed commitment's class-level digest array ((S, 8)
    int64 words, host) for stage `tag` of claim `key`, with the package's
    code hash: an edit to how leaves are derived would make a loaded tree
    disagree with the rows derived again, and the prove would fail only at
    verify time."""
    os.makedirs(directory, exist_ok=True)
    path = _commit_path(directory, key, tag)
    tmp = os.path.join(directory, f".tmp{os.getpid()}_{tag}.npz")
    np.savez(
        tmp, digests=np.asarray(digests, dtype=np.int64),
        code=np.frombuffer(package_code_hash().encode(), dtype=np.uint8),
    )
    os.replace(tmp, path)
    return path


def load_commit_stage(directory: str, key: str, tag: str):
    """The (S, 8) int64 digest array saved for (key, tag), or None. A file
    of another code version or another format is removed."""
    path = _commit_path(directory, key, tag)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        code = data["code"].tobytes().decode() if "code" in data.files else None
        digests = data["digests"] if "digests" in data.files else None
    if code != package_code_hash() or digests is None:
        os.remove(path)  # stale: never resume from it
        return None
    return digests


def save_proof(directory: str, key: str, proof: bytes) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"proof_{key}.bin")
    with open(path, "wb") as fh:
        fh.write(proof)
    return path


def load_proof(directory: str, key: str) -> Optional[bytes]:
    path = os.path.join(directory, f"proof_{key}.bin")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return fh.read()
