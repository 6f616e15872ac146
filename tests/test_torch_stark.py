"""Torch port end to end: seeded proofs equal the JAX package's bytes, on
the resident and on the streamed path, the two verifiers accept each
other's proofs, tampering is rejected, the port needs a CUDA device unless
asked for the CPU, and it imports no JAX."""

import ast
import os

import numpy as np
import pytest
import torch

import stark_brainfuck_tpu as J
import stark_brainfuck_tpu_torch as TP
from stark_brainfuck_tpu_torch.protocol.channel import ProofStream

torch.set_num_threads(1)

P = 2**64 - 2**32 + 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAMS = {
    "plus4": ("++++", "", 0),
    "io": (",+.", "a", 0),
    "loop": ("+>[+<-]", "", 0),
    # FRI domain 16384: past device_commit_min, so the port commits with
    # device trees (plain torch BLAKE2b here) while JAX's numpy path uses
    # host trees
    "device_commit": ("+" * 8 + "[->++++[-]<]", "", 7),
}

_CACHE = {}


def _setup(key):
    src, inp, seed = {**PROGRAMS, **STREAM_PROGRAMS}[key]
    program = J.VirtualMachine.compile(src)
    tr = J.VirtualMachine.simulate(program, inp)
    args = (tr["processor"], tr["memory"], tr["instruction"],
            tr["input"], tr["output"])

    def make(pkg, **kw):
        cfg = {"seed": seed, **kw.pop("config", {})}
        return pkg.BrainfuckStark(
            tr["processor"].shape[0], tr["memory"].shape[0], program, inp,
            tr["output_data"], pkg.StarkConfig(**cfg), **kw,
        )

    return make, args


def _proofs(key):
    """(jax stark, jax proof, port stark, port proof), computed once."""
    if key not in _CACHE:
        make, args = _setup(key)
        jb = make(J)
        tb = make(TP, device="cpu")
        _CACHE[key] = (jb, jb.prove(*args, xp=np), tb, tb.prove(*args))
    return _CACHE[key]


def _mxu_proof(key):
    """(port stark, port proof) with ntt_backend="mxu", computed once."""
    if ("mxu", key) not in _CACHE:
        make, args = _setup(key)
        tb = make(TP, device="cpu", config={"ntt_backend": "mxu"})
        _CACHE["mxu", key] = (tb, tb.prove(*args))
    return _CACHE["mxu", key]


@pytest.mark.parametrize("key", list(PROGRAMS))
def test_seeded_proof_bytes_equal_jax(key):
    jb, pj, tb, pt = _proofs(key)
    assert pt == pj
    if key == "device_commit":
        assert tb.fri.domain.length >= tb.config.device_commit_min
        assert tb.last_metrics["hash_path"] == "torch-plain"


@pytest.mark.parametrize("key", list(PROGRAMS))
def test_proofs_cross_verify(key):
    jb, pj, tb, pt = _proofs(key)
    assert tb.verify(pj), tb.last_rejection
    assert jb.verify(pt), jb.last_rejection


# plus4: a single sub-NTT (N <= 2^13); device_commit: N = 2^14, the
# composed four-step path with r = c = 128
MXU_GEOMETRY = {"plus4": False, "device_commit": True}


@pytest.mark.parametrize("key", list(MXU_GEOMETRY))
def test_mxu_seeded_proof_bytes_equal_jax(key):
    _, pj, tb0, _ = _proofs(key)
    tb, pt = _mxu_proof(key)
    assert pt == pj
    assert tb.last_metrics["ntt_path"] == "four-step-plain"
    assert tb0.last_metrics["ntt_path"] == "u64-torch"
    plan = tb._lde_packs()["fwd"]
    assert (plan.sub_c is not None) == MXU_GEOMETRY[key]
    if MXU_GEOMETRY[key]:
        assert (plan.r, plan.c) == (128, 128)


@pytest.mark.parametrize("key", list(MXU_GEOMETRY))
def test_mxu_proofs_cross_verify(key):
    jb, pj, _, _ = _proofs(key)
    tb, pt = _mxu_proof(key)
    assert tb.verify(pj), tb.last_rejection
    assert jb.verify(pt), jb.last_rejection


# streamed (strided-class) proves: `stream_min=1` sends every domain down the
# streamed path, 4 classes; the programs and seed of tests/test_stream.py
STREAM = {"stream_min": 1, "stream_classes": 4}
STREAM_PROGRAMS = {
    "io11": (",+.", "a", 11),
    "loop6": ("+" * 6 + "[->++<]", "", 11),
    # FRI domain 16384: device trees for the combination and FRI
    "device_commit": PROGRAMS["device_commit"],
}
STREAM_CASES = [(k, nb) for k in STREAM_PROGRAMS for nb in ("auto", "mxu")]


def _streamed_proof(key, backend):
    if ("streamed", key, backend) not in _CACHE:
        make, args = _setup(key)
        tb = make(TP, device="cpu",
                  config={**STREAM, "ntt_backend": backend})
        _CACHE["streamed", key, backend] = (tb, tb.prove(*args))
    return _CACHE["streamed", key, backend]


@pytest.mark.parametrize("key,backend", STREAM_CASES)
def test_streamed_proof_bytes_equal_jax_and_resident(key, backend):
    _, pj, tb0, pt0 = _proofs(key)
    tb, pt = _streamed_proof(key, backend)
    assert tb.use_stream and not tb0.use_stream
    assert pt == pj, "streamed bytes differ from the JAX resident proof"
    assert pt == pt0, "streamed bytes differ from the port's resident proof"
    m = tb.last_metrics
    assert (m["stream_classes"], m["stream_block"]) == (
        4, tb.fri.domain.length // 4)
    # the JAX rule groups all 4 classes of a block this small
    assert m["stream_group"] == 4
    assert m["ntt_path"] == (
        "four-step-plain" if backend == "mxu" else "u64-torch")
    assert tb._lde_packs()["fwd"] is None, "a streamed prove needs no N pack"
    for stage in ("stage_a (base coeffs)", "base merkle (streamed)",
                  "stage_b (ext coeffs)", "ext merkle (streamed)",
                  "reopen (streamed 2nd pass)"):
        assert stage in m["stages_s"], stage
    assert tb0.last_metrics["stream_classes"] is None


@pytest.mark.parametrize("backend", ["auto", "mxu"])
@pytest.mark.parametrize("group", [1, 2])
def test_streamed_proof_bytes_at_a_forced_group_size(group, backend):
    """A cached plan carrying "group" (as the JAX package reads it) sets
    the classes a dispatch of both commit passes and the reopen; the bytes
    stay the JAX proof's."""
    _, pj, _, _ = _proofs("io11")
    make, args = _setup("io11")
    tb = make(TP, device="cpu", config={**STREAM, "ntt_backend": backend})
    tb._stream_plan()["group"] = group
    assert tb.prove(*args) == pj
    assert tb.last_metrics["stream_group"] == group


@pytest.mark.parametrize("key,backend", STREAM_CASES)
def test_streamed_proofs_cross_verify(key, backend):
    jb, pj, tb0, _ = _proofs(key)
    tb, pt = _streamed_proof(key, backend)
    assert jb.verify(pt), jb.last_rejection
    assert tb0.verify(pt), tb0.last_rejection
    assert tb.verify(pj), tb.last_rejection


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
def test_last_metrics_match_jax(streamed):
    """The port reports every key of the JAX package's `last_metrics`; the
    work counts are equal, and each rate is a positive int exactly where the
    JAX package's is one."""
    if streamed:
        make, args = _setup("plus4")
        jb = make(J, config=dict(STREAM))
        assert jb.prove(*args, xp=np) == _proofs("plus4")[1]
        tb, _ = _streamed_proof("plus4", "auto")
        assert tb.use_stream
    else:
        jb, _, tb, _ = _proofs("plus4")
    jm, tm = jb.last_metrics, tb.last_metrics
    assert set(jm) <= set(tm), set(jm) - set(tm)
    for key in ("ntt_butterflies", "hash_leaves"):
        assert type(tm[key]) is int and tm[key] == jm[key], key
    for key in ("ntt_butterflies_per_s", "hash_leaves_per_s",
                "extend_rows_per_s"):
        if jm[key] is None:
            assert tm[key] is None, key
        else:
            assert type(tm[key]) is int and tm[key] > 0, key


def test_stream_classes_are_cut_to_the_unit_distance():
    """B is cut to the smallest table unit distance (the transition's row
    shift must stay inside a class) and never below 2."""
    make, _ = _setup("io")
    tb = make(TP, device="cpu", config={"stream_min": 1})
    N = tb.fri.domain.length
    ud = min(t.unit_distance(N) for t in tb.tables if t.height > 0)
    assert tb.config.stream_classes == 32
    assert tb._stream_plan()["B"] == min(32, ud) >= 2
    assert tb._stream_plan() is tb._stream_plan()


def test_default_stream_min_is_2_22():
    make, _ = _setup("plus4")
    tb = make(TP, device="cpu")
    assert tb.config.stream_min == 1 << 22 and not tb.use_stream


def test_tampered_streamed_opening_rejected():
    tb, pt = _streamed_proof("io11", "auto")

    def mutate(objs):
        el = list(objs[10])  # the first opened extension leaf
        c = list(el[0])
        c[0] = (int(c[0]) + 1) % P
        el[0] = tuple(c)
        objs[10] = tuple(el)

    assert "extension codeword opening" in _tampered(tb, pt, mutate)


def _tampered(tb, proof, mutate):
    ps = ProofStream.deserialize(proof)
    mutate(ps.objects)
    assert not tb.verify(ps.serialize()), "tampered proof must be rejected"
    assert tb.last_rejection
    return tb.last_rejection


def test_tampered_terminal_rejected():
    _, _, tb, pt = _proofs("plus4")

    def mutate(objs):
        t = list(objs[2])
        t[0] = (t[0] + 1) % P
        objs[2] = tuple(t)

    _tampered(tb, pt, mutate)


def test_tampered_base_opening_rejected():
    _, _, tb, pt = _proofs("plus4")

    def mutate(objs):
        el = list(objs[8])
        el[1] = (int(el[1]) + 1) % P
        objs[8] = tuple(el)

    assert "base codeword opening" in _tampered(tb, pt, mutate)


def test_tampered_fri_last_codeword_rejected():
    _, _, tb, pt = _proofs("device_commit")

    def mutate(objs):
        for i in range(len(objs) - 1, -1, -1):
            if isinstance(objs[i], list) and objs[i] and isinstance(objs[i][0], tuple):
                last = list(objs[i])
                c = list(last[0])
                c[0] = (c[0] + 1) % P
                last[0] = tuple(c)
                objs[i] = last
                return
        raise AssertionError("no last codeword in the proof")

    assert "FRI" in _tampered(tb, pt, mutate)


def test_wrong_public_output_rejected():
    jb, pj, _, _ = _proofs("io")
    src, inp, seed = PROGRAMS["io"]
    program = TP.VirtualMachine.compile(src)
    tr = TP.VirtualMachine.simulate(program, inp)
    lying = TP.BrainfuckStark(
        tr["processor"].shape[0], tr["memory"].shape[0], program, inp, "X",
        TP.StarkConfig(seed=seed), device="cpu",
    )
    assert not lying.verify(pj)


def test_default_device_needs_cuda():
    program = TP.VirtualMachine.compile("++++")
    tr = TP.VirtualMachine.simulate(program)
    args = (tr["processor"].shape[0], tr["memory"].shape[0], program, "",
            tr["output_data"], TP.StarkConfig(seed=0))
    if torch.cuda.is_available():
        assert TP.BrainfuckStark(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.BrainfuckStark(*args)


@pytest.mark.parametrize(
    "fields",
    [
        {"mesh_shape": (("shard", 2),)},
        {"codec": "pickle"},
        {"ntt_backend": "int8"},
    ],
)
def test_unported_options_raise(fields):
    """A mesh outside a process group of its size (tests/test_torch_parallel.py
    proves inside one), an unknown codec and an unknown NTT backend are
    refused with ValueError; every option of the JAX package is ported."""
    from dataclasses import asdict

    from stark_brainfuck_tpu_torch.convert import config_from_fields

    cfg = config_from_fields({**asdict(J.StarkConfig(seed=1)), **fields})
    program = TP.VirtualMachine.compile("++++")
    tr = TP.VirtualMachine.simulate(program)
    with pytest.raises(ValueError):
        TP.BrainfuckStark(tr["processor"].shape[0], tr["memory"].shape[0],
                          program, "", tr["output_data"], cfg, device="cpu")


# -- the rest of tests/test_tamper.py and the Mallory trace of
# tests/test_stark.py, on the port's resident plus4 proof. Native-format
# object layout: 0 = base root, 1 = ext root, 2-6 = terminals, 7 =
# combination root, then per query index and unit distance [base element,
# (salt, path), ext element, (salt, path)], then per query index
# [combination leaf, path], then FRI.


def test_tampered_base_salt_rejected():
    _, _, tb, pt = _proofs("plus4")

    def mutate(objs):
        salt, path = objs[9]
        objs[9] = (bytes([salt[0] ^ 1]) + salt[1:], path)

    assert "base codeword opening" in _tampered(tb, pt, mutate)


def test_tampered_ext_opening_element_rejected():
    _, _, tb, pt = _proofs("plus4")

    def mutate(objs):
        el = [tuple(c) for c in objs[10]]
        c0 = list(el[0])
        c0[0] = (int(c0[0]) + 1) % P
        el[0] = tuple(c0)
        objs[10] = tuple(el)

    assert "extension codeword opening" in _tampered(tb, pt, mutate)


def test_tampered_ext_path_rejected():
    _, _, tb, pt = _proofs("plus4")

    def mutate(objs):
        salt, path = objs[11]
        path = list(path)
        path[0] = bytes([path[0][0] ^ 0xFF]) + path[0][1:]
        objs[11] = (salt, path)

    assert "extension codeword opening" in _tampered(tb, pt, mutate)


def test_tampered_combination_leaf_rejected():
    _, _, tb, pt = _proofs("plus4")

    def mutate(objs):
        # the first 3-tuple of ints after the openings
        i = next(i for i in range(8, len(objs))
                 if isinstance(objs[i], tuple) and len(objs[i]) == 3
                 and all(isinstance(v, int) for v in objs[i]))
        leaf = list(objs[i])
        leaf[2] = (leaf[2] + 1) % P
        objs[i] = tuple(leaf)

    assert "combination" in _tampered(tb, pt, mutate)


def test_tampered_fri_root_rejected():
    _, _, tb, pt = _proofs("plus4")

    def mutate(objs):
        # the last 64-byte bytes object: a late FRI round's root
        i = next(i for i in range(len(objs) - 1, 7, -1)
                 if isinstance(objs[i], bytes) and len(objs[i]) == 64)
        objs[i] = bytes([objs[i][0] ^ 1]) + objs[i][1:]

    assert "FRI" in _tampered(tb, pt, mutate)


def _forged(src, trace, seed):
    """(port stark, its proof of `trace`, JAX stark, JAX proof): the
    same forged trace through both provers."""
    program = J.VirtualMachine.compile(src)
    args = (trace["processor"], trace["memory"], trace["instruction"],
            trace["input"], trace["output"])
    out = []
    for pkg, kw, pkw in ((TP, {}, {"device": "cpu"}), (J, {"xp": np}, {})):
        bfs = pkg.BrainfuckStark(
            trace["processor"].shape[0], trace["memory"].shape[0], program,
            "", trace["output_data"], pkg.StarkConfig(seed=seed), **pkw)
        out += [bfs, bfs.prove(*args, **kw)]
    return out


def test_memory_sorting_attack_rejected():
    """The mirror of tests/test_tamper.py::test_memory_sorting_attack_
    rejected: a memory matrix sorted by (mp, clk) without the dummy rows
    that erase clk jumps proves, to the JAX package's bytes, and is
    rejected by both verifiers."""
    program = J.VirtualMachine.compile("+>++<-")
    trace = J.VirtualMachine.simulate(program)
    processor = trace["processor"]
    rows = processor[processor[:, 2] != 0]
    order = np.lexsort(
        (rows[:, 0].astype(np.int64), rows[:, 4].astype(np.int64)))
    sel = rows[order][:, [0, 4, 5]]
    forged = np.concatenate(
        [sel, np.zeros((sel.shape[0], 1), dtype=np.uint64)], axis=1
    ).astype(np.uint64)
    assert forged.shape != trace["memory"].shape or (
        forged != trace["memory"]).any()
    tb, pt, jb, pj = _forged("+>++<-", {**trace, "memory": forged}, 5)
    assert pt == pj
    assert not tb.verify(pt) and not jb.verify(pt)
    assert tb.last_rejection == jb.last_rejection
    assert "FRI" in tb.last_rejection


def test_mallory_forged_trace_rejected():
    """The mirror of tests/test_stark.py::test_mallory_forged_trace_
    rejected: Mallory's forged execution proves, to the JAX package's
    bytes, and fails the low-degree test in both verifiers."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_stark import mallory_simulate

    forged = mallory_simulate(J.VirtualMachine.compile("+>[++<-]"))
    tb, pt, jb, pj = _forged("+>[++<-]", {**forged, "output_data": ""}, 3)
    assert pt == pj
    assert not tb.verify(pt) and not jb.verify(pt)
    assert tb.last_rejection == jb.last_rejection
    assert "FRI low-degree test failed" in tb.last_rejection


def _both_provers(src, seed):
    """[(port stark, its prove arguments), (JAX stark, its arguments)] of a
    program without input, traced by the JAX package."""
    program = J.VirtualMachine.compile(src)
    tr = J.VirtualMachine.simulate(program, "")
    args = (tr["processor"], tr["memory"], tr["instruction"], tr["input"],
            tr["output"])
    out = []
    for pkg, kw, pkw in ((TP, {}, {"device": "cpu"}), (J, {"xp": np}, {})):
        bfs = pkg.BrainfuckStark(
            tr["processor"].shape[0], tr["memory"].shape[0], program, "",
            tr["output_data"], pkg.StarkConfig(seed=seed), **pkw)
        out.append((bfs, lambda bfs=bfs, kw=kw: bfs.prove(*args, **kw)))
    return out


def test_output_outside_a_byte_proves_and_is_rejected_as_in_jax():
    """A fault both packages share (vm/machine.py:214 and :285 of the JAX
    package): `-.` outputs p - 1, but the public output is chr(v % 256),
    so the proof never verifies. Both provers emit the same bytes and both
    verifiers reject them for the same reason."""
    (tb, prove_t), (jb, prove_j) = _both_provers("-.", 7)
    pt, pj = prove_t(), prove_j()
    assert pt == pj and len(pt) == 20582
    for bfs in (tb, jb):
        for proof in (pt, pj):
            assert not bfs.verify(proof)
            assert bfs.last_rejection == ("output evaluation terminal does "
                                          "not match the public output")


def test_empty_program_raises_index_error_as_in_jax():
    """A fault both packages share (models/memory.py:115 of the JAX
    package): the empty program's memory table has no rows, and both
    provers raise IndexError at its terminal, inc[-1]."""
    for bfs, prove in _both_provers("", 1):
        with pytest.raises(IndexError):
            prove()


def _port_sources():
    pkg = os.path.join(ROOT, "stark_brainfuck_tpu_torch")
    for base, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_no_jax():
    forbidden = ("jax", "jaxlib", "stark_brainfuck_tpu")
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in forbidden, f"{path} imports {n}"
