"""The reference-pickle codec of the torch port (`codec="ref"`), against the
JAX package's.

A seeded port proof with `codec="ref"` must equal the JAX package's
`prove(xp=np)` bytes with the same config, memo back-references of the
pickle included; each side's verifier accepts the other's proof; the port
accepts the golden vector `tests/vectors/ref_proof_plus4.bin` (a proof made
by the reference prover) and rejects it with a terminal changed. The shim
classes must pickle the same whichever package registers them first, and
the codec must work in a process that never imports JAX. On 2 gloo ranks a
ref-codec proof equals the single-device one. Tolerance: none, the bytes
must be equal.

JAX is imported inside the helpers, not at the top: the rank processes
import this module for `battery` and need no JAX.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import stark_brainfuck_tpu_torch as TP
from stark_brainfuck_tpu_torch.parallel.multihost import spawn_ranks

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "vectors", "ref_proof_plus4.bin")
P = 2**64 - 2**32 + 1

# key -> (source, input, seed, config beside codec="ref")
PROGRAMS = {
    "plus4": ("++++", "", 0, {}),
    "io": (",+.", "a", 0, {}),
    # FRI domain 16384: past device_commit_min, where the native codec
    # commits on the device; the reference codec stays on host trees
    "n16384": ("+" * 8 + "[->++++[-]<]", "", 7, {}),
}

_CACHE = {}


def _stark(pkg, key, device=None, **config):
    src, inp, seed, own = PROGRAMS[key]
    program = pkg.VirtualMachine.compile(src)
    tr = pkg.VirtualMachine.simulate(program, inp)
    kw = {} if device is None else {"device": device}
    bfs = pkg.BrainfuckStark(
        tr["processor"].shape[0], tr["memory"].shape[0], program, inp,
        tr["output_data"],
        pkg.StarkConfig(**{"seed": seed, "codec": "ref", **own, **config}),
        **kw)
    return bfs, (tr["processor"], tr["memory"], tr["instruction"],
                 tr["input"], tr["output"])


def _proofs(key):
    """(jax stark, jax numpy proof, port stark, port proof), computed once
    (the FRI-2^14 pair takes about 15 s a side: host pickling per leaf)."""
    if key not in _CACHE:
        import stark_brainfuck_tpu as J

        jb, args = _stark(J, key)
        tb, _ = _stark(TP, key, device="cpu")
        _CACHE[key] = (jb, jb.prove(*args, xp=np), tb, tb.prove(*args))
    return _CACHE[key]


@pytest.mark.parametrize("key", list(PROGRAMS))
def test_ref_codec_proof_bytes_equal_jax(key):
    _, pj, tb, pt = _proofs(key)
    assert pt == pj
    m = tb.last_metrics
    assert m["hash_path"] == "host-hashlib"
    assert m["blake2b_launches"] == 0  # plain versions on the CPU
    assert "base merkle" in m["stages_s"]


@pytest.mark.parametrize("key", list(PROGRAMS))
def test_ref_codec_proofs_cross_verify(key):
    jb, pj, tb, pt = _proofs(key)
    assert tb.verify(pj), tb.last_rejection
    assert jb.verify(pt), jb.last_rejection
    assert tb.last_rejection is None


def test_ref_codec_proof_differs_from_native():
    _, _, tb, pt = _proofs("plus4")
    tn, args = _stark(TP, "plus4", device="cpu", codec="native")
    assert tn.prove(*args) != pt
    assert tb.codec.name == "ref" and tn.codec.name == "native"


def test_port_accepts_golden_reference_proof():
    tb = _proofs("plus4")[2]
    assert tb.verify(open(GOLDEN, "rb").read()), tb.last_rejection


def _tamper_terminal(proof):
    from stark_brainfuck_tpu_torch.interop.ref_shims import ensure_ref_modules

    ensure_ref_modules()
    objects = pickle.loads(proof)
    c = objects[2].polynomial.coefficients[0]
    c.value = (c.value + 1) % P
    return pickle.dumps(objects)


@pytest.mark.parametrize("which", ["own", "golden"])
def test_ref_codec_rejects_tampered_terminal(which):
    """The mirror of tests/test_interop.py::test_ref_codec_rejects_tamper,
    on the port's own proof and on the golden vector."""
    tb, pt = _proofs("plus4")[2:]
    proof = pt if which == "own" else open(GOLDEN, "rb").read()
    assert not tb.verify(_tamper_terminal(proof))
    # the terminals feed the Fiat-Shamir draw of the query indices, so the
    # first opening the verifier checks is at an index nobody opened
    assert "base codeword opening" in tb.last_rejection


def test_ref_codec_never_streams():
    """As in the JAX package, the reference codec keeps every domain
    resident, whatever stream_min says; the bytes are the resident ones."""
    _, pj, _, pt = _proofs("io")
    tb, args = _stark(TP, "io", device="cpu", stream_min=1,
                      stream_classes=4)
    assert not tb.use_stream
    assert tb.prove(*args) == pt == pj


def _run(code, timeout=240):
    env = {"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": "/tmp",
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           **{k: v for k, v in os.environ.items() if k.startswith("LD_")}}
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT, env=env)


def test_shim_only_ref_codec_roundtrip():
    """The mirror of tests/test_interop.py::test_shim_only_ref_codec_roundtrip
    with the port alone: a process that imports only
    stark_brainfuck_tpu_torch proves and verifies with the shims and accepts
    the golden vector, and never imports JAX."""
    out = _run(r"""
import sys
sys.path = [p for p in sys.path if "reference" not in p]
import torch
torch.set_num_threads(1)
from stark_brainfuck_tpu_torch import BrainfuckStark, StarkConfig, VirtualMachine

program = VirtualMachine.compile("++++")
trace = VirtualMachine.simulate(program)
bfs = BrainfuckStark(
    trace["processor"].shape[0], trace["memory"].shape[0], program, "",
    trace["output_data"], StarkConfig(seed=0, codec="ref"), device="cpu",
)
proof = bfs.prove(trace["processor"], trace["memory"], trace["instruction"],
                  trace["input"], trace["output"])
assert bfs.verify(proof), bfs.last_rejection
golden = open("tests/vectors/ref_proof_plus4.bin", "rb").read()
assert bfs.verify(golden), "shims must parse the reference-produced proof"
assert type(bfs.codec.bf).__module__ == "algebra"
assert "jax" not in sys.modules, "the port imported jax"
assert "stark_brainfuck_tpu" not in sys.modules
print("SHIM_OK", len(proof))
""")
    assert "SHIM_OK" in out.stdout, out.stderr[-2000:]


@pytest.mark.parametrize("first", ["port", "jax"])
def test_codecs_pickle_alike_whichever_registers_first(first):
    """One process builds one package's RefCodec, then the other's: both
    must take the same shim classes from sys.modules and pickle the same
    objects to the same bytes."""
    out = _run(f"""
import pickle
order = {["port", "jax"] if first == "port" else ["jax", "port"]!r}
codecs = {{}}
for name in order:
    if name == "port":
        from stark_brainfuck_tpu_torch.interop.refcodec import RefCodec
    else:
        from stark_brainfuck_tpu.interop.refcodec import RefCodec
    codecs[name] = RefCodec()
port, jax = codecs["port"], codecs["jax"]
for attr in ("BaseFieldElement", "BaseField", "Polynomial",
             "ExtensionFieldElement", "ExtensionField"):
    assert getattr(port, attr) is getattr(jax, attr), attr
leaf = ((1, 2, 0), 5, (0, 0, 0))
assert port.leaf_payload(leaf) == jax.leaf_payload(leaf)
assert port.salted_payload(leaf, b"s" * 24) == jax.salted_payload(leaf, b"s" * 24)
streams = []
for codec in (port, jax):
    ps = codec.make_stream()
    x = (7, 8, 9)
    for obj in (b"root", x, [x, (1, 0, 0)], 3, x):
        ps.push(obj)
    streams.append(ps.serialize())
    assert codec.load_stream(streams[-1]).pull() == b"root"
assert streams[0] == streams[1]
print("ORDER_OK", order)
""")
    assert "ORDER_OK" in out.stdout, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# 2 gloo ranks
# ---------------------------------------------------------------------------

# device trees would be sharded over the ranks here under the native codec;
# under the reference codec the ranks gather and build host trees, and
# stream_min=1 must leave the mesh resident instead of refusing it; the
# DEBUG checks gather the rank's codeword blocks
MESH_CONFIG = {"device_commit_min": 1024, "stream_min": 1,
               "debug_degree_checks": True}


def battery(mesh, payload):
    """What every rank proves: the ref-codec proof of plus4 on the mesh."""
    bfs, args = _stark(TP, "plus4", device="cpu",
                       mesh_shape=(("shard", mesh.world),), **MESH_CONFIG)
    proof = bfs.prove(*args)
    return {"proof": proof, "use_stream": bfs.use_stream,
            "sharded_commit": bfs.last_metrics["mesh"]["sharded_commit"],
            "hash_path": bfs.last_metrics["hash_path"]}


def test_ref_codec_mesh_bytes_equal_single_device():
    import stark_brainfuck_tpu as J

    got = spawn_ranks("test_torch_interop:battery", 2, {}, device="cpu",
                      timeout=600, python_path=[HERE])
    _, pt = _proofs("plus4")[2:]
    jb, args = _stark(J, "plus4", **MESH_CONFIG)
    assert jb.prove(*args, xp=np) == pt
    for r in got:
        assert r["proof"] == pt
        assert not r["use_stream"] and not r["sharded_commit"]
        assert r["hash_path"] == "host-hashlib"
