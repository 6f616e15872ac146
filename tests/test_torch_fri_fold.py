"""FRI's fold round (`ops/fri_kernels.py`): kernel F5 (`csrc/fri.cu`) on the
card, the host tail's fold (`native/fri_host.cpp`, F5's body `csrc/fri.cuh`
under g++) and the plain torch fold (`fold_math` on `geometric_rows`).

Field arithmetic is exact, so every comparison is equality of canonical
u64 words (tolerance 0). On the CPU, with inputs made by numpy from a seed:

  - the native host fold equals the JAX package's `_fold_math(xp=np)` on
    the 1/x_i table of its numpy tail (stark_brainfuck_tpu/protocol/
    fri.py:347-362) and the port's plain fold, at N = 2^1 .. 2^16, at three
    (omega, offset) pairs with a start index other than 0, and on edge
    words (0, 1, p - 1; alpha 0, 1 and (p - 1, p - 1, p - 1)); built to
    fold every round in parallel, or none, it folds the same;
  - `Fri.commit` on the CPU gives the JAX package's roots and transcript
    with its device-tree rounds on the plain fold and its host rounds on
    the native one, one span `round` (an entry of `fri_round_s`) a fold;
  - seeded whole proves equal the JAX package's `prove(xp=np)` bytes, with
    every host round on the native fold: all rounds host, a device round
    then the host tail, and the reference codec;
  - the dispatch: a codeword that reports a CUDA device reaches F5's
    launcher once a round (the one device and a mesh rank's start), through
    a stand-in that runs the host build of the same body, and goes op by
    op nowhere; a failed launch raises; what the fold does not take raises.

On the card (marked `cuda`, skipped here): F5 against the plain fold.
chip_smoke.py holds F5 to the plain fold at the prover's shapes."""

import contextlib
import os
import re

import numpy as np
import pytest
import torch

import stark_brainfuck_tpu as J
import stark_brainfuck_tpu_torch as TP
from stark_brainfuck_tpu.ops import field as jf
from stark_brainfuck_tpu.protocol import fri as jfri
from stark_brainfuck_tpu.protocol.channel import ProofStream as JProofStream
from stark_brainfuck_tpu_torch.convert import tensor_to_u64 as U
from stark_brainfuck_tpu_torch.convert import u64_to_tensor as T
from stark_brainfuck_tpu_torch.ops import field as tf
from stark_brainfuck_tpu_torch.ops import fri_kernels as fk
from stark_brainfuck_tpu_torch.ops import xfield as txf
from stark_brainfuck_tpu_torch.protocol import fri as tfri
from stark_brainfuck_tpu_torch.protocol.channel import ProofStream
from stark_brainfuck_tpu_torch.utils.metrics import SpanRecorder

torch.set_num_threads(1)

P = 2**64 - 2**32 + 1
HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "stark_brainfuck_tpu_torch", "csrc", "fri.cuh")
EDGES = (0, 1, P - 1)


def _codeword(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=(n, 3), dtype=np.uint64)


def _alpha(seed):
    rng = np.random.default_rng(seed)
    return tuple(int(v) for v in rng.integers(0, P, size=3, dtype=np.uint64))


def _jax_fold(cw, alpha, omega, offset, start=0):
    """The JAX package's host-tail fold: 1/x_i = offset^-1·omega^-(start+i)
    as its numpy tail builds the table (`powers`, then one multiply), and
    `_fold_math(xp=np)`."""
    half = cw.shape[0] // 2
    s = jf.h_mul(jf.h_inverse(offset),
                 jf.h_pow(jf.h_inverse(omega), start))
    ixs = jf.mul(jf.powers(jf.h_inverse(omega), half, np),
                 np.asarray(s, dtype=np.uint64), np)
    return jfri._fold_math(cw, np.asarray(alpha, dtype=np.uint64), ixs, np)


def _all_three(cw, alpha, omega, offset, start=0):
    """The native host fold, held to the JAX fold and the port's plain
    fold; returns it."""
    got = fk.fold_host(T(cw), alpha, omega, offset, start)
    assert tuple(got.shape) == (cw.shape[0] // 2, 3)
    want = _jax_fold(cw, alpha, omega, offset, start)
    assert np.array_equal(U(got), want)
    assert torch.equal(got, fk.fold_plain(T(cw), alpha, omega, offset, start))
    return got


# ---------------------------------------------------------------------------
# the native host fold against both packages' plain folds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_n", range(1, 17))
def test_host_fold_equals_both_plain_folds(log_n):
    n = 1 << log_n
    _all_three(_codeword(n, log_n), _alpha(100 + log_n),
               tf.primitive_nth_root(n), tf.GENERATOR)


# (omega, offset): a round-0 domain, a folded round's squares, and a root
# of a larger domain with a random offset (a mesh rank's round)
PAIRS = [
    (tf.primitive_nth_root(1 << 12), tf.GENERATOR),
    (tf.h_mul(tf.primitive_nth_root(1 << 13), tf.primitive_nth_root(1 << 13)),
     tf.h_mul(tf.GENERATOR, tf.GENERATOR)),
    (tf.primitive_nth_root(1 << 20), 0x1234_5678_9ABC_DEF0 % P),
]


@pytest.mark.parametrize("pair", range(len(PAIRS)))
@pytest.mark.parametrize("start", [1, 1000, (1 << 19) + 77])
def test_host_fold_at_a_start_index(pair, start):
    omega, offset = PAIRS[pair]
    _all_three(_codeword(1 << 11, pair), _alpha(pair), omega, offset, start)


@pytest.mark.parametrize("alpha", [(0, 0, 0), (1, 0, 0), (P - 1,) * 3,
                                   (0, P - 1, 1)])
def test_host_fold_on_edge_words(alpha):
    """Every pair of edge elements (27 x 27 halves), the chunked loop's
    ragged end (729 outputs) included."""
    e = np.array(EDGES, dtype=np.uint64)
    elems = np.stack(np.meshgrid(e, e, e, indexing="ij"), -1).reshape(-1, 3)
    lo = np.repeat(elems, len(elems), axis=0)
    hi = np.tile(elems, (len(elems), 1))
    _all_three(np.concatenate([lo, hi]), alpha, tf.primitive_nth_root(1024),
               tf.GENERATOR, 3)


def test_host_fold_is_parallel_past_its_threshold_and_the_same():
    """A round of 2^15 outputs (past the parallel threshold: chunks on
    several threads) equals the same round folded in 32 parts of 2^10
    outputs, each on one thread below the threshold, from its own start
    index."""
    n = 1 << 16
    cw, alpha = _codeword(n, 5), _alpha(5)
    omega, offset = tf.primitive_nth_root(n), tf.GENERATOR
    whole = fk.fold_host(T(cw), alpha, omega, offset)
    for k in range(32):
        lo, hi = k * n // 64, (k + 1) * n // 64
        part = np.concatenate([cw[lo:hi], cw[n // 2 + lo:n // 2 + hi]])
        got = fk.fold_host(T(part), alpha, omega, offset, lo)
        assert torch.equal(got, whole[lo:hi]), k


@pytest.mark.parametrize("parallel_min", [1, 1 << 40])
def test_parallel_threshold_leaves_the_fold_unchanged(parallel_min):
    """The host fold built with every round in parallel, or none, is a
    library of its own and folds as the shipped one does, at a ragged
    round of several chunks and at a round of one output."""
    import ctypes

    from stark_brainfuck_tpu_torch.ops import cuda_build

    path = cuda_build.build_host(
        ["fri_host"], [f"FRI_FOLD_PARALLEL_MIN={parallel_min}"])["fri_host"]
    assert path != cuda_build.build_host(["fri_host"])["fri_host"]
    fn = ctypes.CDLL(path).fri_fold_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    for n, start in ((2 * 3000, 7), (2, 0)):
        cw = T(_codeword(n, n))
        alpha = _alpha(n)
        omega, offset = PAIRS[2]
        got = cw.new_empty((n // 2, 3))
        fn(cw.data_ptr(), n // 2, fk.fold_words(alpha, omega, offset, start),
           got.data_ptr())
        assert torch.equal(got, _all_three(U(cw), alpha, omega, offset,
                                           start)), n


def test_the_wrappers_constants_are_the_headers():
    text = open(HEADER).read()
    ladder = int(re.search(r"kFoldLadder = (\d+);", text).group(1))
    assert fk.LADDER == ladder
    assert re.search(r"kFoldWords = 5 \+ kFoldLadder;", text)
    omega, offset = PAIRS[2]
    words = list(fk.fold_words((5, 6, 7), omega, offset, 9))
    r = tf.h_inverse(omega)
    assert words[:4] == [5, 6, 7, tf.h_inverse(2)]
    assert words[4] == tf.h_mul(tf.h_inverse(offset), tf.h_pow(r, 9))
    assert words[5:] == [tf.h_pow(r, 1 << k) for k in range(fk.LADDER)]


# ---------------------------------------------------------------------------
# commit and whole proves on the CPU
# ---------------------------------------------------------------------------


class _Calls:
    """Counts the calls of fri_kernels' folds, each still run."""

    def __init__(self, monkeypatch):
        self.calls = {"fold_host": [], "fold_plain": []}
        for name in self.calls:
            inner = getattr(fk, name)

            def wrapper(cw, *args, _inner=inner, _name=name):
                self.calls[_name].append(int(cw.shape[0]))
                return _inner(cw, *args)

            monkeypatch.setattr(fk, name, wrapper)


@pytest.mark.parametrize("on_device", [True, False],
                         ids=["device_rounds_then_host", "host_rounds"])
def test_commit_roots_and_round_times_with_the_native_tail(monkeypatch,
                                                           on_device):
    n = 2048
    omega = tf.primitive_nth_root(n)
    coeffs = np.random.default_rng(3).integers(0, P, size=(n // 4, 3),
                                               dtype=np.uint64)
    cw = jfri.FriDomain(tf.GENERATOR, omega, n).xevaluate(coeffs)
    calls = _Calls(monkeypatch)
    fri = tfri.Fri(tf.GENERATOR, omega, n, 4, 8, device_commit_min=1024)
    ps = ProofStream()
    with SpanRecorder("cpu") as recorder:
        lengths, objs, trees = fri.commit(T(cw), ps, on_device=on_device)
    jf_ = jfri.Fri(jf.GENERATOR, omega, n, 4, 8)
    jps = JProofStream()
    jcws, jobjs, jtrees = jf_.commit(cw, jps)
    assert [t.root() for t in trees] == [t.root() for t in jtrees]
    assert lengths == [c.shape[0] for c in jcws]
    assert ps.serialize() == jps.serialize()
    folds = fri.num_rounds() - 1
    rounds = [s.path for s in recorder.record.spans if s.name == "round"]
    assert rounds == ["prove/round"] * folds
    device = [n >> r for r in range(folds) if on_device and n >> r >= 1024]
    assert calls.calls["fold_plain"] == device
    assert calls.calls["fold_host"] == [n >> r for r in range(len(device),
                                                              folds)]


# key -> (source, input, seed, config)
PROVES = {
    # FRI 2^10: no device trees, every round on the host
    "plus4": ("++++", "", 0, {}),
    # FRI 2^14: round 0 on device trees (plain torch here), then the tail
    "device_round_then_tail": ("+" * 8 + "[->++++[-]<]", "", 7, {}),
    # the reference codec: host trees over pickled leaves, every round
    "ref_codec": ("++++", "", 0, {"codec": "ref"}),
}


@pytest.mark.parametrize("key", list(PROVES))
def test_seeded_proof_bytes_equal_jax_with_the_native_tail(monkeypatch, key):
    src, inp, seed, config = PROVES[key]
    program = J.VirtualMachine.compile(src)
    tr = J.VirtualMachine.simulate(program, inp)
    args = (tr["processor"], tr["memory"], tr["instruction"], tr["input"],
            tr["output"])

    def make(pkg, **kw):
        return pkg.BrainfuckStark(
            tr["processor"].shape[0], tr["memory"].shape[0], program, inp,
            tr["output_data"], pkg.StarkConfig(seed=seed, **config), **kw)

    calls = _Calls(monkeypatch)
    tb = make(TP, device="cpu")
    proof = tb.prove(*args)
    assert proof == make(J).prove(*args, xp=np)
    fri = tb.fri
    N, folds = fri.domain.length, fri.num_rounds() - 1
    device = ([N >> r for r in range(folds) if N >> r >= fri.host_min]
              if tb._device_commit() else [])
    assert calls.calls["fold_plain"] == device
    assert calls.calls["fold_host"] == [N >> r for r in range(len(device),
                                                              folds)]
    assert len(tb.last_metrics["fri_round_s"]) == folds
    if key == "device_round_then_tail":
        assert device == [N]
    assert tb.verify(proof), tb.last_rejection


# ---------------------------------------------------------------------------
# dispatch, against a stand-in launcher
# ---------------------------------------------------------------------------


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that the wrapper takes
    its kernel path against a stand-in launcher."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(x):
    return x.as_subclass(_ReportsCuda)


class _HostLaunch:
    """csrc/fri.cu's library, stood in for by the g++ build of the same
    body: records each launch's arguments, then runs it on the host (or
    returns `rc`)."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def fri_fold_launch(self, cw, half, words, out, stream):
        self.calls.append((cw, half, list(words), out, stream))
        if self.rc:
            return self.rc
        fk.native.get_fri_lib().fri_fold_host(cw, half, words, out)
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    lib = _HostLaunch()
    monkeypatch.setattr(fk, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(fk, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return lib


def _forbid_op_by_op(monkeypatch):
    """Every F1/F2 dispatch, `geometric_rows` and the host fold fail from
    here on."""

    def never(*args, **kw):
        raise AssertionError("a CUDA codeword went another way than F5")

    for mod, name in ((tf, "add"), (tf, "sub"), (tf, "mul"),
                      (tf, "geometric_rows"), (txf, "add"), (txf, "sub"),
                      (txf, "mul"), (txf, "mul_base"), (fk, "fold_host"),
                      (fk, "fold_plain")):
        monkeypatch.setattr(mod, name, never)


class _OneRankOfTwo:
    """`parallel/mesh.py`'s fold pairs as rank 1 of 2 sees them: the second
    halves of the codeword's low and high halves."""

    rank, world = 1, 2

    def __init__(self, whole):
        self.whole = whole

    def fold_pairs(self, block):
        n = self.whole.shape[0]
        q = n // 4
        return _cuda(torch.cat([self.whole[q:2 * q], self.whole[3 * q:]]))


@pytest.mark.parametrize("path", ["one_device", "mesh_rank"])
def test_cuda_codeword_takes_one_f5_launch(stand_in, monkeypatch, path):
    n = 1 << 12
    cw, alpha = T(_codeword(n, 7)), _alpha(7)
    omega, offset = tf.primitive_nth_root(n), tf.GENERATOR
    whole = fk.fold_plain(cw, alpha, omega, offset)
    _forbid_op_by_op(monkeypatch)
    before = fk.LAUNCHES_FOLD
    if path == "one_device":
        got = tfri._fold_device(_cuda(cw), alpha, omega, offset)
        want, half, start = whole, n // 2, 0
    else:
        mesh = _OneRankOfTwo(cw)
        block = _cuda(cw[n // 2:])  # the rank's block: only its size counts
        got = tfri._fold_sharded(block, alpha, omega, offset, mesh)
        want, half, start = whole[n // 4:], n // 4, n // 4
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    assert fk.LAUNCHES_FOLD == before + 1
    (ptr, h, words, out, stream), = stand_in.calls
    assert (h, stream) == (half, 0)
    assert out == got.data_ptr()
    assert words == list(fk.fold_words(alpha, omega, offset, start))


def test_a_failed_launch_raises_and_is_not_counted(stand_in):
    stand_in.rc = 700  # cudaErrorIllegalAddress
    before = fk.LAUNCHES_FOLD
    with pytest.raises(RuntimeError, match="cudaError 700"):
        fk.fold(_cuda(T(_codeword(64, 1))), (1, 2, 3), 5, 7)
    assert fk.LAUNCHES_FOLD == before


BAD = {
    "int32": lambda cw: cw.to(torch.int32),
    "odd_n": lambda cw: cw[:-1],
    "two_columns": lambda cw: cw[:, :2],
    "strided": lambda cw: cw[::2],
    "flat": lambda cw: cw.reshape(-1),
}


@pytest.mark.parametrize("fn", ["fold", "fold_host"])
@pytest.mark.parametrize("bad", list(BAD))
def test_a_fold_raises_for_what_it_does_not_take(fn, bad):
    cw = BAD[bad](T(_codeword(64, 2)))
    with pytest.raises(ValueError):
        getattr(fk, fn)(cw, (1, 2, 3), 5, 7)


def test_the_host_fold_takes_a_cpu_codeword_only():
    with pytest.raises(ValueError, match="CPU codeword"):
        fk.fold_host(_cuda(T(_codeword(64, 3))), (1, 2, 3), 5, 7)
    with pytest.raises(ValueError, match="coefficients"):
        fk.fold_host(T(_codeword(64, 3)), (1, 2), 5, 7)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_fold():
    """On the card: F5 against the plain fold, at one and at many blocks,
    with a start index, and on edge words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel F5 has no CPU mode)")
    for n, start in ((2, 0), (1 << 10, 0), (1 << 16, 0), (1 << 16, 12345),
                     ((1 << 11) + 6, 3)):
        cw = T(_codeword(n, n), "cuda")
        alpha = _alpha(n)
        omega, offset = tf.primitive_nth_root(1 << 16), tf.GENERATOR
        got = fk.fold(cw, alpha, omega, offset, start)
        want = fk.fold_plain(cw.cpu(), alpha, omega, offset, start)
        assert torch.equal(got.cpu(), want), (n, start)
