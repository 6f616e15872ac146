"""The rank's view of a 1-D mesh, and the port's only collectives.

The counterpart of the JAX package's `parallel/mesh.py` (`make_mesh`,
`codeword_spec`). There one process drives D devices and the compiler
partitions every array that carries a sharding constraint, inserting the
collectives itself. Here the mesh is the `torch.distributed` process group:
one process per rank, every rank runs the same host logic (seeded rng,
Fiat-Shamir, transcript) and holds the contiguous block
[rank·N/D, (rank+1)·N/D) of every codeword, the layout `codeword_spec`
gives (`Mesh.block`). Each place where the prover mixes codeword indices is
an explicit call of one of the collectives below; nothing else in the
package calls `torch.distributed`.

Backend. `nccl` when every rank has a card of its own; else `gloo`, which
moves CPU tensors: a CUDA tensor is then staged through pinned host memory
inside `_run`, in and out, and the compute stays on the card (ranks that
share one card are processes with a context each). Which of the two a mesh
uses is decided once, in `init_process_group`, from the devices and not
from a failure; `describe()` reports it.

Field words are int64 tensors holding u64 bits: the collectives only copy
them. Nothing here reduces (an unsigned order or a float sum would be wrong
on them).
"""

from __future__ import annotations

import datetime
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# a codeword is split over the ranks only while each block keeps at least
# this many leaves (one leaf-hash launch unit of the TPU kernel, and enough
# that every rank keeps a node of the level the tree's top is gathered at)
MIN_BLOCK = 128


def mesh_size(mesh_shape) -> int:
    """Number of ranks a `StarkConfig.mesh_shape` asks for (1 for None)."""
    size = 1
    for _, n in mesh_shape or ():
        size *= int(n)
    return size


def rank_device(rank: int, device=None) -> torch.device:
    """The device of a rank: cuda:(rank mod device count) unless the caller
    names the CPU (or one card). A rank without a card raises."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {rank} has no CUDA device: pass device='cpu' to prove on "
            f"the CPU"
        )
    return torch.device("cuda", rank % torch.cuda.device_count())


def pick_backend(world: int, device=None) -> str:
    """`nccl` when the ranks are on cards and each has its own, else
    `gloo` (CUDA tensors staged through pinned host memory)."""
    if device is not None and torch.device(device).type != "cuda":
        return "gloo"
    if (torch.cuda.is_available() and torch.cuda.device_count() >= world
            and dist.is_nccl_available()):
        return "nccl"
    return "gloo"


def init_process_group(init_method: str, world: int, rank: int, device=None,
                       timeout_s: float = 600.0) -> str:
    """Join the process group of a mesh; returns the backend chosen. Every
    collective that waits longer than `timeout_s` for a peer raises."""
    backend = pick_backend(world, device)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(rank, device))
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return backend


def shutdown():
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class Mesh:
    """World size, rank, device and the collectives of one rank. `stats`
    counts, per collective, the calls, the bytes this rank sent and received,
    the seconds it spent (staging and waiting for peers included) and, of
    those, the seconds of the torch copies that pack what is sent into one
    buffer and join what was received."""

    def __init__(self, world: int, rank: int, device, backend: str):
        self.world = world
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self.stats: Dict[str, List[float]] = {}
        self._pinned: Dict[str, torch.Tensor] = {}
        names: List[Optional[str]] = [None] * world
        dist.all_gather_object(names, str(self.device))
        self.devices = names

    # -- layout --------------------------------------------------------------

    def block(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's block of an axis of length n."""
        if n % self.world:
            raise ValueError(f"{self.world} ranks do not divide length {n}")
        size = n // self.world
        return self.rank * size, (self.rank + 1) * size

    def shardable(self, n: int) -> bool:
        """Whether a codeword of n leaves is committed in blocks: each rank
        keeps at least MIN_BLOCK of them. Shorter ones are gathered and
        every rank goes on as one device does."""
        return n % self.world == 0 and n // self.world >= MIN_BLOCK

    def describe(self) -> Dict:
        return {"world": self.world, "rank": self.rank,
                "backend": self.backend, "devices": list(self.devices)}

    # -- stats ---------------------------------------------------------------

    def reset_stats(self):
        self.stats = {}

    def stats_report(self) -> Dict:
        per = {k: {"calls": int(v[0]), "bytes": int(v[1]),
                   "seconds": round(v[2], 4), "copy_seconds": round(v[3], 4)}
               for k, v in self.stats.items()}
        return {"collectives": per,
                "collective_bytes": sum(p["bytes"] for p in per.values()),
                "collective_s": round(sum(v[2] for v in self.stats.values()),
                                      4),
                "collective_copy_s": round(
                    sum(v[3] for v in self.stats.values()), 4)}

    # -- the one place a collective runs ---------------------------------------

    def _host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """A pinned host buffer of t's size for staging (kept and regrown)."""
        buf = self._pinned.get(slot)
        if buf is None or buf.numel() < t.numel():
            buf = torch.empty(max(t.numel(), 1), dtype=torch.int64,
                              pin_memory=True)
            self._pinned[slot] = buf
        return buf[: t.numel()].view(t.shape)

    def _run(self, name: str, call, src: torch.Tensor, dst: torch.Tensor):
        """call(src, dst) on the group: directly where the backend moves the
        tensors' device, else through pinned host copies of both."""
        if src.dtype != torch.int64 or dst.dtype != torch.int64:
            raise ValueError("the mesh moves int64 words only")
        if src.is_cuda:
            # the kernels still running belong to their stage, not here
            torch.cuda.synchronize(src.device)
        t0 = time.time()
        staged = self.backend == "gloo" and src.is_cuda
        if staged:
            h_src, h_dst = self._host(src, "src"), self._host(dst, "dst")
            h_src.copy_(src)
            call(h_src, h_dst)
            dst.copy_(h_dst)
        else:
            call(src, dst)
        if src.is_cuda:
            torch.cuda.synchronize(src.device)
        s = self.stats.setdefault(name, [0, 0, 0.0, 0.0])
        s[0] += 1
        s[1] += 8 * (src.numel() + dst.numel())
        s[2] += time.time() - t0
        return dst

    def _copy(self, name: str, make, like: torch.Tensor):
        """make(): a torch copy around the collective `name` (packing its
        send buffer, joining what it received), timed into its stats."""
        if like.is_cuda:
            torch.cuda.synchronize(like.device)
        t0 = time.time()
        out = make()
        if like.is_cuda:
            torch.cuda.synchronize(like.device)
        s = self.stats.setdefault(name, [0, 0, 0.0, 0.0])
        spent = time.time() - t0
        s[2] += spent
        s[3] += spent
        return out

    # -- collectives -----------------------------------------------------------

    def exchange(self, send: Sequence[torch.Tensor],
                 recv_shapes: Sequence[Sequence[int]],
                 name: str = "exchange") -> List[torch.Tensor]:
        """Personalised exchange: send[j] goes to rank j (any may be empty),
        and what rank j sent here comes back as item j, of the shape
        recv_shapes[j], which the caller knows from the layout."""
        assert len(send) == self.world and len(recv_shapes) == self.world
        dev = send[0].device
        in_splits = [int(s.numel()) for s in send]
        out_splits = [_numel(shape) for shape in recv_shapes]
        src = self._copy(
            name, lambda: torch.cat([s.reshape(-1) for s in send]), send[0])
        dst = torch.empty(sum(out_splits), dtype=torch.int64, device=dev)
        self._run(
            name,
            lambda a, b: dist.all_to_all_single(b, a, out_splits, in_splits),
            src, dst,
        )
        out, pos = [], 0
        for shape, count in zip(recv_shapes, out_splits):
            out.append(dst[pos : pos + count].reshape(tuple(shape)))
            pos += count
        return out

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int):
        """Tiled all-to-all: x is cut in `world` chunks along `split_dim`,
        chunk j goes to rank j, and the chunks received are joined along
        `concat_dim` in rank order."""
        parts = list(x.chunk(self.world, dim=split_dim))
        assert len(parts) == self.world and all(
            p.shape == parts[0].shape for p in parts)
        got = self.exchange(parts, [parts[0].shape] * self.world,
                            name="all_to_all")
        return self._copy("all_to_all",
                          lambda: torch.cat(got, dim=concat_dim), x)

    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   counts: Optional[Sequence[int]] = None,
                   name: str = "all_gather"):
        """Every rank's x joined along `dim` in rank order, on every rank.
        `counts`, the length of each rank's x along dim 0 where they differ
        (known to all from the layout), needs dim == 0."""
        if counts is None:
            src = x.contiguous()
            dst = torch.empty((self.world,) + tuple(x.shape),
                              dtype=torch.int64, device=x.device)
            self._run(name, _all_gather,
                      src, dst)
            return torch.cat(list(dst.unbind(0)), dim=dim)
        assert dim == 0 and int(x.shape[0]) == counts[self.rank]
        widest = max(counts)
        src = torch.zeros((widest,) + tuple(x.shape[1:]), dtype=torch.int64,
                          device=x.device)
        src[: x.shape[0]] = x
        dst = torch.empty((self.world,) + tuple(src.shape),
                          dtype=torch.int64, device=x.device)
        self._run(name, _all_gather,
                  src, dst)
        return torch.cat([dst[r, :c] for r, c in enumerate(counts)], dim=0)

    def roll(self, x: torch.Tensor, shift: int, dim: int, length: int):
        """Block of torch.roll(global, -shift, dim): out[i] = global[(i +
        shift) mod length], where x is this rank's block along `dim` of a
        global axis of `length`. The shift may exceed a block, so the rows
        come from rank (r + shift // n) mod D and its successor."""
        n = int(x.shape[dim])
        assert n * self.world == length
        q, s = divmod(shift % length, n)
        if q == 0 and s == 0:
            return x
        D, r = self.world, self.rank
        head, tail = x.narrow(dim, 0, s), x.narrow(dim, s, n - s)
        empty = x.new_empty((0,))
        send = [empty] * D
        shapes: List[Sequence[int]] = [(0,)] * D
        # out[:n-s] is the tail of rank r+q, out[n-s:] the head of r+q+1
        send[(r - q) % D] = tail
        shapes[(r + q) % D] = tuple(tail.shape)
        if s:
            send[(r - q - 1) % D] = head
            shapes[(r + q + 1) % D] = tuple(head.shape)
        got = self.exchange(send, shapes, name="roll")
        if not s:
            return got[(r + q) % D]
        return torch.cat([got[(r + q) % D], got[(r + q + 1) % D]], dim=dim)

    def fold_pairs(self, x: torch.Tensor):
        """For a split-and-fold of the global codeword (index i paired with
        i + N/2): this rank's block x (n, ...) of the N-long codeword ->
        (n, ...) whose first half is the block [r·n/2, (r+1)·n/2) of the
        codeword's low half and whose second half is the same block of its
        high half, so that the folded codeword is again in contiguous
        blocks. The rank that will own folded block j pulls from ranks
        j // 2 and j // 2 + D/2."""
        D, r = self.world, self.rank
        n = int(x.shape[0])
        assert D % 2 == 0 and n % 2 == 0
        half = n // 2
        base = 2 * (r % (D // 2))
        empty = x.new_empty((0,))
        send = [empty] * D
        send[base], send[base + 1] = x[:half], x[half:]
        shapes: List[Sequence[int]] = [(0,)] * D
        piece = (half,) + tuple(x.shape[1:])
        shapes[r // 2] = piece
        shapes[r // 2 + D // 2] = piece
        got = self.exchange(send, shapes, name="fold_pairs")
        return torch.cat([got[r // 2], got[r // 2 + D // 2]], dim=0)

    def broadcast_bytes(self, data: Optional[bytes], length: int) -> bytes:
        """Rank 0's `length` bytes (a multiple of 8), on every rank."""
        assert length % 8 == 0
        if self.rank == 0:
            t = torch.frombuffer(bytearray(data), dtype=torch.int64).clone()
        else:
            t = torch.zeros(length // 8, dtype=torch.int64)
        t = t.to(self.device)
        out = torch.empty_like(t)

        def call(a, b):
            dist.broadcast(a, src=0)
            b.copy_(a)

        self._run("broadcast", call, t, out)
        return out.cpu().numpy().tobytes()


def _all_gather(src: torch.Tensor, dst: torch.Tensor):
    """dst[r] = rank r's src, through the list form every backend has."""
    dist.all_gather(list(dst.unbind(0)), src)


def _numel(shape) -> int:
    count = 1
    for d in shape:
        count *= int(d)
    return count


def group_size() -> int:
    """World size of the process group this process has joined (1: none)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(n_devices: Optional[int] = None,
              device=None) -> Optional[Mesh]:
    """The mesh over the ranks of the initialised process group (`None` for
    one rank: the single-device code runs). `n_devices`, where given, must
    be the group's world size. The mesh is 1-D and its one axis needs no
    name here: no layout reads one."""
    world = group_size()
    grouped = dist.is_available() and dist.is_initialized()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"mesh of {n_devices} ranks, but the process group has {world}"
            + ("" if grouped else " (none is initialised)")
            + ": start one process per rank "
            "(stark_brainfuck_tpu_torch.parallel.multihost)"
        )
    if world == 1:
        return None
    rank = dist.get_rank()
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(world, rank, dev, dist.get_backend())


def codeword_block(mesh: Optional[Mesh], x: torch.Tensor, axis: int):
    """This rank's block of a replicated tensor along `axis`: the layout
    the JAX package's `codeword_spec` names."""
    if mesh is None:
        return x
    lo, hi = mesh.block(int(x.shape[axis]))
    return x.narrow(axis, lo, hi - lo)
