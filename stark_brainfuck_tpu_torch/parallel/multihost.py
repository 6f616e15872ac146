"""Multi-process execution: one process per rank of the mesh.

The counterpart of the JAX package's `parallel/multihost.py`. There a
process group is an extra (`jax.distributed` spans hosts, each driving its
local devices); in the port it is how every mesh runs: `torch.distributed`
is SPMD, one process per rank, and `BrainfuckStark` with `mesh_shape` proves
on whichever group the process has joined.

  - `init_from_env` joins the group named by the same three variables:
    STARK_COORDINATOR (`host:port`, or a `file://` path for ranks of one
    machine), STARK_NUM_PROCESSES, STARK_PROCESS_ID; STARK_DEVICE (`cpu`,
    default the cards) and STARK_TIMEOUT_S (collective timeout) beside them.
  - Every rank runs the same program. All prover inputs are
    host-deterministic (seeded rng, trace matrices), so each rank builds its
    own replicated tensors from the same host values, and the transcript is
    bit-identical on every rank because every Fiat-Shamir input is.
  - `to_host` / `fetch_global` are gathers of the rank's blocks.
  - `spawn_ranks` starts the ranks of one machine as worker processes of
    this module and returns what a named function returned on each;
    `spawn_dryrun` is the dry run built on it: every rank runs the sharded
    core (or the full prove) and the common digest comes back.

    python -m stark_brainfuck_tpu_torch.parallel.multihost

with the three variables set runs one rank of the dry run and prints
`MULTIHOST_DIGEST <sha256>` (STARK_DRYRUN_MODE=prove for the full prove,
STARK_DRYRUN_SEED for the seed).

A fault must end the run, not stall it: the group has a timeout, every
worker a wall-clock limit, and when one worker exits non-zero its siblings,
which would wait for it inside a collective, are killed.

No counterpart here: `GlobalXp` and `replicate_tree` (they turn host values
into replicated global arrays, the input form a multi-controller jit needs;
a rank's ordinary tensor is already that), the jitted identity with
replicated `out_shardings` behind JAX's `to_host`, and the per-process
device-count flags of its `spawn_dryrun`.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..convert import tensor_to_u64
from . import mesh as M

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def init_from_env() -> bool:
    """Join the process group when STARK_COORDINATOR is set. Env:
    STARK_COORDINATOR=host:port (or file://path), STARK_NUM_PROCESSES,
    STARK_PROCESS_ID; optional STARK_DEVICE and STARK_TIMEOUT_S. Returns
    True when a group was joined."""
    coord = os.environ.get("STARK_COORDINATOR")
    if not coord:
        return False
    if "://" not in coord:
        coord = f"tcp://{coord}"
    M.init_process_group(
        coord,
        int(os.environ["STARK_NUM_PROCESSES"]),
        int(os.environ["STARK_PROCESS_ID"]),
        device=os.environ.get("STARK_DEVICE") or None,
        timeout_s=float(os.environ.get("STARK_TIMEOUT_S", "600")),
    )
    return True


def env_device():
    """The device the environment names for this rank (None: its card)."""
    return os.environ.get("STARK_DEVICE") or None


def fetch_global(arr, mesh: Optional[M.Mesh], dim: int = 0) -> np.ndarray:
    """Full host value (u64) of a tensor held in blocks along `dim`, on
    every rank; a tensor of one rank is just read."""
    if mesh is not None:
        arr = mesh.all_gather(arr, dim=dim)
    return tensor_to_u64(arr)


def to_host(tree, mesh: Optional[M.Mesh] = None):
    """Host values of the blocks in a (possibly nested) list or tuple of
    tensors, gathered along axis 0 under a mesh."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(t, mesh) for t in tree)
    return fetch_global(tree, mesh)


def _program(src: str):
    from ..vm.machine import VirtualMachine

    program = VirtualMachine.compile(src)
    return program, VirtualMachine.simulate(program)


def run_core_global(seed: int = 0, src: str = "++++", device=None,
                    **config) -> np.ndarray:
    """The sharded prover core over a mesh of all the ranks of the process
    group; returns the full combination codeword on every rank."""
    from .prover import dryrun_sharded_prove

    return dryrun_sharded_prove(M.group_size(), src, seed, device=device,
                                **config)


def run_full_prove_global(seed: int = 0, src: str = "++++", device=None,
                          **config) -> bytes:
    """The complete prove (commitments, Fiat-Shamir transcript, FRI,
    openings, serialisation) with every codeword in blocks over all the
    ranks of the process group. Every rank runs the identical host logic and
    returns the same proof bytes. `device_commit_min` is lowered so that
    the tiny trace takes the device commitment path of the big proves."""
    from ..config import StarkConfig
    from ..protocol.stark import BrainfuckStark

    program, trace = _program(src)
    cfg = StarkConfig(**{
        "seed": seed, "mesh_shape": (("shard", M.group_size()),),
        "device_commit_min": 1024, **config,
    })
    bfs = BrainfuckStark(
        trace["processor"].shape[0], trace["memory"].shape[0], program, "",
        trace["output_data"], cfg, device=device,
    )
    return bfs.prove(
        trace["processor"], trace["memory"], trace["instruction"],
        trace["input"], trace["output"],
    )


def dryrun_digest(mode: str = "core", seed: int = 0, device=None) -> str:
    """sha256 of the dry run's full result on this rank's group."""
    if mode == "prove":
        return hashlib.sha256(
            run_full_prove_global(seed=seed, device=device)).hexdigest()
    acc = run_core_global(seed=seed, device=device)
    return hashlib.sha256(
        np.ascontiguousarray(acc.astype("<u8")).tobytes()).hexdigest()


def _dryrun_target(mesh, payload):
    """`spawn_ranks` target of `spawn_dryrun`."""
    return dryrun_digest(payload["mode"], payload["seed"], env_device())


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def _worker_main(argv: Sequence[str]):
    """Entry of a rank's process. With `--call module:function DIR`: join
    the group, call function(mesh, payload) with the payload pickled in
    DIR, and leave the pickled result there. Without: one rank of the dry
    run, printing its digest."""
    device = env_device()
    if device == "cpu":
        torch.set_num_threads(1)
    init_from_env()
    try:
        if len(argv) >= 3 and argv[0] == "--call":
            target, workdir = argv[1], argv[2]
            with open(os.path.join(workdir, "payload.pkl"), "rb") as fh:
                payload = pickle.load(fh)
            mesh = M.make_mesh(device=device)
            result = _resolve(target)(mesh, payload)
            rank = int(os.environ.get("STARK_PROCESS_ID", "0"))
            tmp = os.path.join(workdir, f"result_{rank}.tmp")
            with open(tmp, "wb") as fh:
                pickle.dump(result, fh)
            os.replace(tmp, os.path.join(workdir, f"result_{rank}.pkl"))
        else:
            digest = dryrun_digest(
                os.environ.get("STARK_DRYRUN_MODE", "core"),
                int(os.environ.get("STARK_DRYRUN_SEED", "0")), device,
            )
            print(f"MULTIHOST_DIGEST {digest}", flush=True)
    finally:
        M.shutdown()


def spawn_ranks(target: str, world: int, payload=None,
                device: Optional[str] = None, timeout: float = 600.0,
                port: int = 0, python_path: Sequence[str] = ()) -> List:
    """Run `target` ("module:function") as function(mesh, payload) on
    `world` worker processes of this machine, joined in one process group,
    and return the results by rank. `device`: None or "cuda" for the cards
    (rank r on cuda:(r mod count); a rank without a card raises), or "cpu"
    where the caller asks for it. The rendezvous is a file in a temporary
    directory unless a `port` is given (as the JAX package's dry run
    takes). A worker that exits non-zero, or the wall-clock `timeout`, kills
    every worker and raises with the end of each worker's output."""
    with tempfile.TemporaryDirectory(prefix="stark_ranks_") as workdir:
        with open(os.path.join(workdir, "payload.pkl"), "wb") as fh:
            pickle.dump(payload, fh)
        coord = (f"127.0.0.1:{port}" if port
                 else "file://" + os.path.join(workdir, "rendezvous"))
        path = os.pathsep.join(
            [_REPO_ROOT, *python_path]
            + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
               else []))
        env_base = {
            **os.environ,
            "PYTHONPATH": path,
            "STARK_COORDINATOR": coord,
            "STARK_NUM_PROCESSES": str(world),
            "STARK_TIMEOUT_S": str(timeout),
            "OMP_NUM_THREADS": "1",
        }
        # the workers take `device`, not what this process was started with
        env_base.pop("STARK_DEVICE", None)
        if device is not None:
            env_base["STARK_DEVICE"] = device
        procs, logs = [], []
        for rank in range(world):
            log = open(os.path.join(workdir, f"log_{rank}.txt"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "stark_brainfuck_tpu_torch.parallel.multihost", "--call",
                 target, workdir],
                env={**env_base, "STARK_PROCESS_ID": str(rank)},
                stdout=log, stderr=subprocess.STDOUT, cwd=_REPO_ROOT,
            ))
        try:
            fault = _wait_all(procs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        tails = []
        for rank, log in enumerate(logs):
            log.seek(0)
            tails.append(f"[rank {rank}] " + log.read()[-2000:])
            log.close()
        if fault:
            raise RuntimeError(
                f"{target} on {world} ranks: {fault}\n" + "\n".join(tails))
        results = []
        for rank in range(world):
            with open(os.path.join(workdir, f"result_{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results


def _wait_all(procs, timeout: float) -> Optional[str]:
    """Wait for every worker; returns what went wrong, or None. Does not
    wait for the siblings of a worker that failed."""
    deadline = time.time() + timeout
    while True:
        codes = [p.poll() for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            return "; ".join(f"rank {r} exited with code {c}" for r, c in bad)
        if all(c == 0 for c in codes):
            return None
        if time.time() > deadline:
            return f"not finished after {timeout} s"
        time.sleep(0.05)


def spawn_dryrun(num_processes: int = 2, port: int = 0, timeout: int = 1800,
                 seed: int = 0, mode: str = "core",
                 device: Optional[str] = None) -> str:
    """Launch `num_processes` worker processes joined in one process group
    on this machine; every worker runs the sharded prover core (or, with
    mode="prove", the full prove) over the mesh of all of them, on the
    cards unless `device` is "cpu". Returns the
    common result digest; raises if workers disagree (which would mean that
    the partitioning changed the math)."""
    digests = spawn_ranks(
        "stark_brainfuck_tpu_torch.parallel.multihost:_dryrun_target",
        num_processes, {"mode": mode, "seed": seed}, device=device,
        timeout=timeout, port=port,
    )
    assert all(d == digests[0] for d in digests), (
        f"multi-process digests disagree: {digests}"
    )
    return digests[0]


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
