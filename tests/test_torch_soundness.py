"""The torch port at soundness parameters other than the defaults, against
the JAX package.

Every other test proves at expansion 4, security level 2 (one colinearity
check) and one randomizer. Here `log_expansion_factor=3`,
`security_level=6` (2 colinearity checks, 6 query indices) and
`num_randomizers=2` change the number of query indices, the openings, the
device trees' prefetch sizes and FRI's round count; a seeded port proof
must still equal the JAX package's `prove(xp=np)` bytes, resident (native
and reference codec, both NTT paths), streamed, and on 2 gloo ranks. A
`slow` mirror of tests/test_stark.py::test_production_security_level runs
security level 64 at expansion 16. Tolerance: none, the bytes must be
equal.

JAX is imported inside the helpers, not at the top: the rank processes
import this module for `battery` and need no JAX.
"""

import os

import numpy as np
import pytest
import torch

import stark_brainfuck_tpu_torch as TP
from stark_brainfuck_tpu_torch.parallel.multihost import spawn_ranks

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))

SOUNDNESS = {"log_expansion_factor": 3, "security_level": 6,
             "num_randomizers": 2}
PROGRAMS = {
    # FRI 1,024: host trees throughout
    "io": (",+.", "a", 0),
    # FRI 32,768: device trees and two device FRI rounds (B1's plain
    # version here), prefetched openings of 6 indices
    "n32768": ("+" * 8 + "[->++++[-]<]", "", 7),
}
# mode -> (program, port config beside SOUNDNESS); the JAX package proves
# with SOUNDNESS and the codec only: the other options change the route,
# never the bytes
MODES = {
    "resident_native": ("io", {}),
    "resident_ref": ("io", {"codec": "ref"}),
    "resident_mxu": ("io", {"ntt_backend": "mxu"}),
    "streamed": ("io", {"stream_min": 1, "stream_classes": 4}),
    "streamed_mxu": ("io", {"stream_min": 1, "stream_classes": 4,
                            "ntt_backend": "mxu"}),
    "device_commit": ("n32768", {}),
}

_CACHE = {}


def _stark(pkg, key, device=None, **config):
    src, inp, seed = PROGRAMS[key]
    program = pkg.VirtualMachine.compile(src)
    tr = pkg.VirtualMachine.simulate(program, inp)
    kw = {} if device is None else {"device": device}
    bfs = pkg.BrainfuckStark(
        tr["processor"].shape[0], tr["memory"].shape[0], program, inp,
        tr["output_data"],
        pkg.StarkConfig(**{"seed": seed, **SOUNDNESS, **config}), **kw)
    return bfs, (tr["processor"], tr["memory"], tr["instruction"],
                 tr["input"], tr["output"])


def _jax_proof(key, **config):
    """(jax stark, jax numpy proof), computed once per config."""
    ck = ("jax", key, tuple(sorted(config.items())))
    if ck not in _CACHE:
        import stark_brainfuck_tpu as J

        jb, args = _stark(J, key, **config)
        _CACHE[ck] = (jb, jb.prove(*args, xp=np))
    return _CACHE[ck]


def _port_proof(mode):
    if mode not in _CACHE:
        key, config = MODES[mode]
        tb, args = _stark(TP, key, device="cpu", **config)
        _CACHE[mode] = (tb, tb.prove(*args))
    return _CACHE[mode]


def _want(mode):
    key, config = MODES[mode]
    return _jax_proof(key, codec=config.get("codec", "native"))


@pytest.mark.parametrize("mode", list(MODES))
def test_soundness_params_bytes_equal_jax(mode):
    tb, pt = _port_proof(mode)
    _, pj = _want(mode)
    assert tb.config.num_colinearity_checks == 2
    assert tb.fri.num_colinearity_tests == 2
    assert tb.use_stream == mode.startswith("streamed")
    assert pt == pj


@pytest.mark.parametrize("mode", list(MODES))
def test_soundness_params_proofs_cross_verify(mode):
    tb, pt = _port_proof(mode)
    jb, pj = _want(mode)
    assert tb.verify(pj), tb.last_rejection
    assert jb.verify(pt), jb.last_rejection


def test_soundness_params_change_the_proof():
    """The parameters reach the transcript: the default-parameter proof of
    the same program and seed differs, and is shorter."""
    tb, pt = _port_proof("resident_native")
    src, inp, seed = PROGRAMS["io"]
    program = TP.VirtualMachine.compile(src)
    tr = TP.VirtualMachine.simulate(program, inp)
    d = TP.BrainfuckStark(
        tr["processor"].shape[0], tr["memory"].shape[0], program, inp,
        tr["output_data"], TP.StarkConfig(seed=seed), device="cpu")
    pd = d.prove(tr["processor"], tr["memory"], tr["instruction"],
                 tr["input"], tr["output"])
    assert pd != pt and len(pd) < len(pt)
    assert d.fri.domain.length != tb.fri.domain.length


def test_security_level_beyond_the_fri_cap_is_refused_by_both():
    """The FRI last codeword holds 2 x expansion values, which caps the
    colinearity checks: security level 160 at expansion 16 (40 checks
    against 32 values) is refused by the JAX package's prover, and by the
    port's, with the same assertion."""
    import stark_brainfuck_tpu as J

    cfg = {"security_level": 160, "log_expansion_factor": 4,
           "num_randomizers": 1}
    errors = []
    for pkg, kw, pkw in ((J, {"xp": np}, {}), (TP, {}, {"device": "cpu"})):
        program = pkg.VirtualMachine.compile("++++")
        tr = pkg.VirtualMachine.simulate(program)
        bfs = pkg.BrainfuckStark(
            tr["processor"].shape[0], tr["memory"].shape[0], program, "",
            tr["output_data"], pkg.StarkConfig(seed=0, **cfg), **pkw)
        assert bfs.config.num_colinearity_checks == 40
        with pytest.raises(AssertionError) as err:
            bfs.prove(tr["processor"], tr["memory"], tr["instruction"],
                      tr["input"], tr["output"], **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1] == (
        "cannot sample more indices than available")


# ---------------------------------------------------------------------------
# 2 gloo ranks
# ---------------------------------------------------------------------------

# trees and FRI rounds in blocks from 1,024 leaves: the FRI-1,024 program is
# sharded across the ranks from round 0
MESH_CONFIG = {"device_commit_min": 1024, "fri_host_min": 1024}


def battery(mesh, payload):
    """What every rank proves at the non-default parameters."""
    out = {}
    for codec in ("native", "ref"):
        bfs, args = _stark(TP, "io", device="cpu", codec=codec,
                           mesh_shape=(("shard", mesh.world),), **MESH_CONFIG)
        out[codec] = {"proof": bfs.prove(*args),
                      "sharded_commit":
                          bfs.last_metrics["mesh"]["sharded_commit"]}
    return out


def test_soundness_params_mesh_bytes_equal_jax():
    got = spawn_ranks("test_torch_soundness:battery", 2, {}, device="cpu",
                      timeout=600, python_path=[HERE])
    for codec, mode in (("native", "resident_native"),
                        ("ref", "resident_ref")):
        _, pj = _want(mode)
        for r in got:
            assert r[codec]["proof"] == pj, codec
            assert r[codec]["sharded_commit"] == (codec == "native")


# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_production_security_level():
    """The mirror of tests/test_stark.py::test_production_security_level:
    expansion 16, security level 64 (16 colinearity checks) proves,
    verifies fast, and equals the JAX package's bytes."""
    import time

    import stark_brainfuck_tpu as J

    proofs = []
    for pkg, kw, pkw in ((J, {"xp": np}, {}), (TP, {}, {"device": "cpu"})):
        program = pkg.VirtualMachine.compile("+>[+<-]")
        tr = pkg.VirtualMachine.simulate(program)
        bfs = pkg.BrainfuckStark(
            tr["processor"].shape[0], tr["memory"].shape[0], program, "",
            tr["output_data"],
            pkg.StarkConfig(seed=0, security_level=64,
                            log_expansion_factor=4), **pkw)
        proofs.append(bfs.prove(tr["processor"], tr["memory"],
                                tr["instruction"], tr["input"], tr["output"],
                                **kw))
    assert proofs[1] == proofs[0]
    t0 = time.time()
    assert bfs.verify(proofs[1]), bfs.last_rejection
    assert time.time() - t0 < 10, "verification must stay fast at higher lambda"
