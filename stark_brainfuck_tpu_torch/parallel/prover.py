"""Sharded prover core: the algebraic pipeline of a prove as one function.

The counterpart of the JAX package's `parallel/prover.py`, same names:
`make_prove_core` composes the prover's stages (base LDE -> extend ->
extension LDE -> quotients + combination) into one function of array
inputs, with stand-in challenges, weights and terminals drawn from a seed,
so the codeword-scale math can be held equal across mesh sizes (and
against the JAX package) without a transcript.

Under a mesh (the `BrainfuckStark` was built with `mesh_shape`, on every
rank of the process group) the core returns the rank's block of the
combination codeword; `dryrun_sharded_prove` gathers it. Where the JAX core
threads sharding constraints through one jitted graph, the stages here
call the collectives of `parallel/mesh.py` themselves.

What the JAX module does for its compiler has no counterpart: the tables
(`packs`, `zinv_flat`, `shift_ratios`) passed as runtime arguments of the
jitted core, and the host laundering of the zerofier arrays (the
ahead-of-time exported module that makes them pins them to one device). The
port's stages
build their tables on the rank's device and cache them on the instance.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..convert import tensor_to_u64, u64_to_tensor
from ..ops import field as f
from ..protocol.stark import BrainfuckStark
from ..utils.rng import Rng

U64 = np.uint64


def prove_core_inputs(bfs: BrainfuckStark, trace: Dict, seed: int = 0) -> Dict:
    """Host-side preparation of every input of the algebraic core
    (randomness, challenge stand-ins, degree-shift tables), in the draw
    order of the JAX package's `prove_core_inputs`; tensors on the
    prover's device, weights and shift tables as host values."""
    dev = bfs.device
    rng = Rng(seed)
    matrices = [
        trace["processor"], trace["instruction"], trace["memory"],
        trace["input"], trace["output"],
    ]
    for t, m in zip(bfs.tables, matrices):
        t.matrix = np.asarray(m, dtype=U64).reshape(-1, t.base_width)
        if len(t.matrix) > 0:
            t.pad()
    mats = tuple(u64_to_tensor(t.matrix, dev) for t in bfs.tables)

    rand_coeffs = u64_to_tensor(rng.x_elements((bfs.max_degree + 1,)), dev)
    base_rands = tuple(
        u64_to_tensor(rng.base_elements((t.base_width, t.num_randomizers)),
                      dev)
        if t.num_randomizers > 0 and t.height > 0 else None
        for t in bfs.tables
    )
    ext_rands = tuple(
        u64_to_tensor(rng.x_elements((t.num_ext_columns, t.num_randomizers)),
                      dev)
        if t.num_randomizers > 0 and t.height > 0 else None
        for t in bfs.tables
    )
    challenges_h = rng.x_elements((11,))
    initials_h = rng.x_elements((2,))

    # stand-in terminals and bounds: a real prove derives these between the
    # stages; the core's arithmetic is the same with placeholders
    challenges_t = [tuple(int(v) for v in challenges_h[i]) for i in range(11)]
    terminals_h = [(0, 0, 0)] * 5
    qdb = []
    for t in bfs.tables:
        qdb += t.all_quotient_degree_bounds(challenges_t, terminals_h)
    for pa in bfs.permutation_arguments:
        qdb.append(pa.quotient_degree_bound())
    all_bounds = bfs._base_degree_bounds() + bfs._ext_degree_bounds() + qdb
    shifts = [bfs.max_degree - b for b in all_bounds]
    offset_pows = [f.h_pow(bfs.fri.domain.offset, s) for s in shifts]
    weights = rng.x_elements((1 + 2 * len(all_bounds),))
    return dict(
        mats=mats, rand_coeffs=rand_coeffs, base_rands=base_rands,
        ext_rands=ext_rands, challenges=u64_to_tensor(challenges_h, dev),
        initials=u64_to_tensor(initials_h, dev), weights=weights,
        shifts=shifts, offset_pows=offset_pows,
        terminals=u64_to_tensor(np.asarray(terminals_h, dtype=U64), dev),
    )


def make_prove_core(bfs: BrainfuckStark):
    """Returns one function running LDE -> extend -> quotients ->
    combination on the prover's device. Under the prover's mesh every
    codeword-scale intermediate is the rank's block over the FRI-domain
    axis, and so is the result."""

    def prove_core(mats, rand_coeffs, base_rands, ext_rands, challenges,
                   initials, weights, shifts, offset_pows, terminals):
        packs = bfs._lde_packs()
        rand_cw, base_cws = bfs._stage_base_lde(
            mats, rand_coeffs, base_rands, packs
        )
        xcols, term_arrays = bfs._device_extend(mats, challenges, initials)
        ext_cws = bfs._stage_ext_lde(xcols, ext_rands, packs)
        acc = bfs._combination_pipeline(
            rand_cw, base_cws, ext_cws, challenges, terminals, weights,
            shifts, offset_pows,
        )
        return acc, term_arrays

    return prove_core


def run_core(bfs: BrainfuckStark, trace: Dict, seed: int = 0):
    """The core on `prove_core_inputs`: (rank's block of the combination
    codeword, terminal arrays)."""
    inputs = prove_core_inputs(bfs, trace, seed=seed)
    return make_prove_core(bfs)(
        inputs["mats"], inputs["rand_coeffs"], inputs["base_rands"],
        inputs["ext_rands"], inputs["challenges"], inputs["initials"],
        inputs["weights"], inputs["shifts"], inputs["offset_pows"],
        inputs["terminals"],
    )


def dryrun_sharded_prove(n_devices: int, src: str = "++++", seed: int = 0,
                         device=None, **config) -> np.ndarray:
    """Run the prover core over a mesh of `n_devices` ranks on tiny shapes
    and return the whole combination codeword (host u64, (N, 3)) on every
    rank. Called by every rank of a process group of that size (one rank
    needs none)."""
    from ..config import StarkConfig
    from ..vm.machine import VirtualMachine

    program = VirtualMachine.compile(src)
    trace = VirtualMachine.simulate(program)
    bfs = BrainfuckStark(
        trace["processor"].shape[0], trace["memory"].shape[0], program, "",
        trace["output_data"],
        StarkConfig(seed=seed, mesh_shape=(("shard", n_devices),), **config),
        device=device,
    )
    acc, _ = run_core(bfs, trace, seed=seed)
    if bfs.mesh is not None:
        acc = bfs.mesh.all_gather(acc)
    return tensor_to_u64(acc)
