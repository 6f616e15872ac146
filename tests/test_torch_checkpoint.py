"""The port's checkpoint/resume (`utils/checkpoint.py`): the cases of
tests/test_checkpoint.py mirrored on the port, and the rules for stage
files: one written by another code version, or by the JAX package, is
removed and never resumed."""

import os

import numpy as np
import pytest
import torch

import stark_brainfuck_tpu as J
import stark_brainfuck_tpu_torch as TP
from stark_brainfuck_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

TRACE_KEYS = ("processor", "memory", "instruction", "input", "output")


def test_trace_roundtrip(tmp_path):
    program = TP.VirtualMachine.compile("++[->+<].")
    trace = TP.VirtualMachine.simulate(program)
    ck.save_trace(str(tmp_path), trace, program)
    loaded = ck.load_trace(str(tmp_path), program)
    assert loaded is not None
    for k in TRACE_KEYS:
        assert (np.asarray(loaded[k]) == np.asarray(trace[k])).all(), k
    assert loaded["output_data"] == trace["output_data"]


def test_load_trace_misses_on_different_program(tmp_path):
    p1 = TP.VirtualMachine.compile("+++")
    p2 = TP.VirtualMachine.compile("++++")
    ck.save_trace(str(tmp_path), TP.VirtualMachine.simulate(p1), p1)
    assert ck.load_trace(str(tmp_path), p2) is None
    assert ck.trace_key(p1) != ck.trace_key(p2)


def test_simulate_cached_hits(tmp_path, monkeypatch):
    program = TP.VirtualMachine.compile(",+.")
    first = ck.simulate_cached(program, "a", directory=str(tmp_path))

    def boom(*a, **k):
        raise AssertionError("cache must be hit, not re-simulated")

    monkeypatch.setattr(TP.VirtualMachine, "simulate", boom)
    second = ck.simulate_cached(program, "a", directory=str(tmp_path))
    assert (second["processor"] == first["processor"]).all()
    assert second["output_data"] == first["output_data"]


def test_proof_cache_roundtrip(tmp_path):
    program = TP.VirtualMachine.compile("+++.")
    cfg = TP.StarkConfig(seed=0)
    key = ck.proof_key(program, "", "x", cfg)
    assert ck.load_proof(str(tmp_path), key) is None
    ck.save_proof(str(tmp_path), key, b"proof-bytes")
    assert ck.load_proof(str(tmp_path), key) == b"proof-bytes"
    # a different claim keys a different slot
    assert ck.proof_key(program, "", "y", cfg) != key


def test_keys_equal_the_jax_package_s():
    """Same claim, same key on both sides: the configs have the same fields
    and so the same repr."""
    from stark_brainfuck_tpu.utils import checkpoint as jck

    program = TP.VirtualMachine.compile(",+.")
    assert ck.trace_key(program, "a") == jck.trace_key(program, "a")
    assert ck.proof_key(program, "a", "b", TP.StarkConfig(seed=3)) == \
        jck.proof_key(program, "a", "b", J.StarkConfig(seed=3))


def _claim(src=",+.", inp="a"):
    program = TP.VirtualMachine.compile(src)
    trace = TP.VirtualMachine.simulate(program, inp)
    args = tuple(trace[k] for k in TRACE_KEYS)

    def build(pkg, cdir, seed=11, **kw):
        return pkg.BrainfuckStark(
            trace["processor"].shape[0], trace["memory"].shape[0], program,
            inp, trace["output_data"],
            pkg.StarkConfig(seed=seed, stream_min=1, stream_classes=4,
                            checkpoint_dir=cdir),
            **kw,
        )

    return build, args


@pytest.mark.parametrize("ntt_backend", ["auto", "mxu"])
def test_stage_level_prove_resume(tmp_path, ntt_backend):
    """A seeded streamed prove keeps per-stage commitment checkpoints; a
    'killed' run (a fresh BrainfuckStark over the same claim) resumes past
    the finished base/ext commit passes to a byte-identical proof and
    records which stages it skipped."""
    cdir = str(tmp_path / "ckpt")
    program = TP.VirtualMachine.compile(",+.")
    trace = TP.VirtualMachine.simulate(program, "a")
    args = tuple(trace[k] for k in TRACE_KEYS)

    def build():
        return TP.BrainfuckStark(
            trace["processor"].shape[0], trace["memory"].shape[0], program,
            "a", trace["output_data"],
            TP.StarkConfig(seed=11, stream_min=1, stream_classes=4,
                           checkpoint_dir=cdir, ntt_backend=ntt_backend),
            device="cpu",
        )

    bfs1 = build()
    proof1 = bfs1.prove(*args)
    assert bfs1.last_commit_resumes == []
    files = sorted(os.listdir(cdir))
    assert [f.split("_")[-1] for f in files] == ["base.npz", "ext.npz"]

    # death after the base commit: the ext checkpoint was never written
    os.remove(os.path.join(cdir, files[1]))
    bfs2 = build()
    proof2 = bfs2.prove(*args)
    assert bfs2.last_commit_resumes == ["base"]
    assert proof2 == proof1, "resumed proof must be byte-identical"
    assert bfs2.verify(proof2)

    # a restart with both checkpoints present skips both passes
    bfs3 = build()
    proof3 = bfs3.prove(*args)
    assert bfs3.last_commit_resumes == ["base", "ext"]
    assert proof3 == proof1
    # and the same instance starts its record anew each prove
    assert bfs3.prove(*args) == proof1
    assert bfs3.last_commit_resumes == ["base", "ext"]


def test_unseeded_prove_never_reuses_commitments(tmp_path):
    """Without a seed the prover draws real randomness: stage checkpoints
    must be neither written nor read."""
    build, args = _claim("++", "")
    cdir = str(tmp_path / "ckpt")
    bfs = build(TP, cdir, seed=None, device="cpu")
    proof = bfs.prove(*args)
    assert bfs.verify(proof)
    assert bfs.last_commit_resumes == []
    assert not os.path.exists(cdir) or os.listdir(cdir) == []


def test_file_with_another_code_hash_is_removed_not_resumed(
        tmp_path, monkeypatch):
    build, args = _claim()
    cdir = str(tmp_path / "ckpt")
    proof1 = build(TP, cdir, device="cpu").prove(*args)
    files = sorted(os.listdir(cdir))
    assert len(files) == 2

    # the same files, as another version of the code would have written
    # them: the next prove must not resume from them
    monkeypatch.setattr(ck, "package_code_hash", lambda: "0" * 16)
    key = files[0].split("_")[2]
    assert ck.load_commit_stage(cdir, key, "base") is None
    assert sorted(os.listdir(cdir)) == [files[1]], "stale file not removed"
    bfs = build(TP, cdir, device="cpu")
    assert bfs.prove(*args) == proof1
    assert bfs.last_commit_resumes == []
    # it wrote both anew, under the patched hash, and those do resume
    assert sorted(os.listdir(cdir)) == files
    bfs = build(TP, cdir, device="cpu")
    assert bfs.prove(*args) == proof1
    assert bfs.last_commit_resumes == ["base", "ext"]


def test_a_jax_package_checkpoint_is_not_resumed(tmp_path):
    """Both packages key a claim alike, so the port's stage files carry a
    name of their own: in a shared directory it neither resumes from the
    JAX package's files (u32 limb planes, its own code hash) nor touches
    them, and each package goes on resuming from its own."""
    build, args = _claim()
    cdir = str(tmp_path / "ckpt")
    proof_j = build(J, cdir).prove(*args, xp=np)
    files_j = sorted(os.listdir(cdir))
    assert [f.split("_")[-1] for f in files_j] == ["base.npz", "ext.npz"]
    kept = {f: open(os.path.join(cdir, f), "rb").read() for f in files_j}
    bfs = build(TP, cdir, device="cpu")
    assert bfs.prove(*args) == proof_j
    assert bfs.last_commit_resumes == []
    files_t = sorted(set(os.listdir(cdir)) - set(files_j))
    assert [f.split("_")[-1] for f in files_t] == ["base.npz", "ext.npz"]
    assert all(f.startswith("commit_torch_") for f in files_t)
    with np.load(os.path.join(cdir, files_t[0])) as data:
        assert "digests" in data.files and data["digests"].dtype == np.int64
    for f, content in kept.items():
        assert open(os.path.join(cdir, f), "rb").read() == content, f
    bfs_j = build(J, cdir)
    assert bfs_j.prove(*args, xp=np) == proof_j
    assert bfs_j.last_commit_resumes == ["base", "ext"]
    bfs = build(TP, cdir, device="cpu")
    assert bfs.prove(*args) == proof_j
    assert bfs.last_commit_resumes == ["base", "ext"]


def test_commit_stage_roundtrip_and_code_hash(tmp_path):
    digests = np.arange(64, dtype=np.int64).reshape(8, 8) - 5
    assert ck.load_commit_stage(str(tmp_path), "k", "base") is None
    ck.save_commit_stage(str(tmp_path), "k", "base", digests)
    got = ck.load_commit_stage(str(tmp_path), "k", "base")
    assert got.dtype == np.int64 and np.array_equal(got, digests)
    assert ck.load_commit_stage(str(tmp_path), "k", "ext") is None
    assert os.listdir(tmp_path) == ["commit_torch_k_base.npz"], "no temp file left"
    h = ck.package_code_hash()
    assert len(h) == 16 and h == ck.package_code_hash()


def test_code_hash_covers_python_and_kernel_sources(tmp_path, monkeypatch):
    """Every .py and every csrc file of the package enters the hash."""
    import shutil

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(ck.__file__)))
    copy = tmp_path / "pkg"
    shutil.copytree(pkg, copy, ignore=shutil.ignore_patterns("__pycache__"))

    def hash_of_copy():
        ck.package_code_hash.cache_clear()
        monkeypatch.setattr(
            ck, "__file__", str(copy / "utils" / "checkpoint.py"))
        try:
            return ck.package_code_hash()
        finally:
            monkeypatch.undo()
            ck.package_code_hash.cache_clear()

    base = hash_of_copy()
    assert base == ck.package_code_hash()
    for rel in ("csrc/blake2b.cu", "protocol/stream.py"):
        with open(copy / rel, "a") as fh:
            fh.write("\n")
        changed = hash_of_copy()
        assert changed != base, rel
        base = changed
