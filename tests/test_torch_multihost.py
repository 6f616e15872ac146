"""The multi-process entry of the torch port: `spawn_dryrun` on two CPU
processes (gloo) against the single-process digests, as
tests/test_multihost.py asserts for the JAX package; the configuration
errors of a mesh; and that a failing rank ends its group instead of stalling
it. Integers and bytes must be equal."""

import hashlib
import os
import time

import numpy as np
import pytest
import torch

import stark_brainfuck_tpu_torch as TP
from stark_brainfuck_tpu_torch.parallel import multihost
from stark_brainfuck_tpu_torch.parallel.mesh import make_mesh, mesh_size

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def _program(src="++++"):
    program = TP.VirtualMachine.compile(src)
    return program, TP.VirtualMachine.simulate(program)


def _stark(tr, program, **config):
    return TP.BrainfuckStark(
        tr["processor"].shape[0], tr["memory"].shape[0], program, "",
        tr["output_data"], TP.StarkConfig(**config), device="cpu")


@pytest.fixture(scope="module")
def dryruns():
    """{mode: digest of the 2-process dry run}; the core run joins over a
    TCP port, the prove run over a file."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return {
        "core": multihost.spawn_dryrun(2, port=port, seed=0, timeout=300,
                                       device="cpu"),
        "prove": multihost.spawn_dryrun(2, mode="prove", seed=0, timeout=300,
                                        device="cpu"),
    }


def test_multiprocess_core_matches_single_process_and_jax(dryruns):
    """Two processes reproduce the one-process core bit-exactly, and that
    is the JAX package's core (numpy path) on the same seed."""
    from stark_brainfuck_tpu import BrainfuckStark, StarkConfig, VirtualMachine
    from stark_brainfuck_tpu.parallel.prover import (
        make_prove_core,
        prove_core_inputs,
    )

    assert dryruns["core"] == multihost.dryrun_digest("core", 0, "cpu")
    program = VirtualMachine.compile("++++")
    tr = VirtualMachine.simulate(program)
    jb = BrainfuckStark(tr["processor"].shape[0], tr["memory"].shape[0],
                        program, "", tr["output_data"], StarkConfig(seed=0))
    inp = prove_core_inputs(jb, tr, seed=0, xp=np)
    acc, _ = make_prove_core(jb, mesh=None, xp=np)(
        inp["mats"], inp["rand_coeffs"], inp["base_rands"], inp["ext_rands"],
        inp["challenges"], inp["initials"], inp["weights"],
        inp["shift_ratios"], inp["offset_pows"], inp["zinv_flat"],
        inp["terminals"], inp["packs"])
    assert dryruns["core"] == hashlib.sha256(
        np.ascontiguousarray(np.asarray(acc).astype("<u8")).tobytes()
    ).hexdigest()


def test_multiprocess_full_prove_bytes_match_single_process(dryruns):
    program, tr = _program()
    bfs = _stark(tr, program, seed=0, device_commit_min=1024)
    proof = bfs.prove(tr["processor"], tr["memory"], tr["instruction"],
                      tr["input"], tr["output"])
    assert bfs.verify(proof)
    assert dryruns["prove"] == hashlib.sha256(proof).hexdigest()
    assert dryruns["prove"] == multihost.dryrun_digest("prove", 0, "cpu")


def test_init_from_env_without_coordinator_joins_nothing(monkeypatch):
    monkeypatch.delenv("STARK_COORDINATOR", raising=False)
    assert multihost.init_from_env() is False
    assert make_mesh() is None and make_mesh(1) is None


def test_to_host_and_fetch_global_without_a_mesh():
    t = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    assert np.array_equal(multihost.fetch_global(t, None),
                          t.numpy().view(np.uint64))
    got = multihost.to_host((t, [t, t]))
    assert isinstance(got, tuple) and isinstance(got[1], list)
    assert got[1][1].dtype == np.uint64


# -- configuration errors -----------------------------------------------------


def test_mesh_larger_than_the_group_raises_with_both_numbers():
    program, tr = _program()
    with pytest.raises(ValueError, match=r"mesh of 4 ranks.*group has 1"):
        _stark(tr, program, seed=0, mesh_shape=(("shard", 4),))


@pytest.mark.parametrize("shape", [(("shard", 3),), (("a", 2), ("b", 3))])
def test_mesh_size_must_be_a_power_of_two(shape):
    assert mesh_size(shape) in (3, 6)
    with pytest.raises(ValueError, match="power of two"):
        TP.StarkConfig(mesh_shape=shape).validate()


def _streamed_mesh(mesh, payload):
    program, tr = _program()
    try:
        _stark(tr, program, seed=0, mesh_shape=(("shard", mesh.world),),
               stream_min=1)
    except ValueError as exc:
        return str(exc)
    return "no error"


def _wrong_size(mesh, payload):
    program, tr = _program()
    try:
        _stark(tr, program, seed=0, mesh_shape=(("shard", 4),))
    except ValueError as exc:
        return str(exc)
    return "no error"


def _rank_one_raises(mesh, payload):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 gives up")
    # the others wait for it in a collective
    return multihost.fetch_global(
        torch.zeros(4, dtype=torch.int64), mesh).shape


@pytest.fixture(scope="module")
def group_errors():
    """Messages of the errors a 2-rank group raises, by case."""
    call = lambda name: multihost.spawn_ranks(  # noqa: E731
        f"test_torch_multihost:{name}", 2, None, device="cpu", timeout=120,
        python_path=[HERE])
    return {"streamed": call("_streamed_mesh"), "size": call("_wrong_size")}


def test_mesh_with_a_streamed_domain_raises(group_errors):
    for message in group_errors["streamed"]:
        assert "mesh_shape with a streamed domain" in message


def test_mesh_size_other_than_the_group_raises_on_every_rank(group_errors):
    for message in group_errors["size"]:
        assert "mesh of 4 ranks, but the process group has 2" in message


def test_a_rank_that_raises_ends_the_group():
    t0 = time.time()
    with pytest.raises(RuntimeError) as info:
        multihost.spawn_ranks(
            "test_torch_multihost:_rank_one_raises", 2, None, device="cpu",
            timeout=120, python_path=[HERE])
    # rank 0 may fail first: its collective loses the peer that gave up
    assert "exited with code 1" in str(info.value)
    assert "rank 1 gives up" in str(info.value)
    assert time.time() - t0 < 60, "the siblings were not killed"


def _sleeps(mesh, payload):
    time.sleep(600)


def test_workers_past_their_wall_clock_limit_are_killed():
    t0 = time.time()
    with pytest.raises(RuntimeError, match="not finished after"):
        multihost.spawn_ranks(
            "test_torch_multihost:_sleeps", 2, None, device="cpu", timeout=8,
            python_path=[HERE])
    assert time.time() - t0 < 60


def test_spawned_ranks_take_the_card_unless_the_cpu_is_named(monkeypatch):
    """No `device`: every rank wants cuda:(rank mod count), and without a
    card it raises instead of proving on the CPU, whatever STARK_DEVICE
    this process was started with."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    monkeypatch.setenv("STARK_DEVICE", "cpu")
    with pytest.raises(RuntimeError, match="has no CUDA device"):
        multihost.spawn_ranks(
            "test_torch_multihost:_sleeps", 2, None, timeout=120,
            python_path=[HERE])
    with pytest.raises(RuntimeError, match="has no CUDA device"):
        multihost.spawn_dryrun(2, timeout=120)
