"""Torch port BLAKE2b and device Merkle layer vs hashlib and the JAX package.

On the CPU the port's `blake2b_words` runs its plain torch version; the
CUDA kernel is held to the same function by the card-only test at the end
and by chip_smoke.py."""

import hashlib

import numpy as np
import pytest
import torch

from stark_brainfuck_tpu.ops import blake2b as JB
from stark_brainfuck_tpu.ops.pallas_blake2b import _kernel_body
from stark_brainfuck_tpu.protocol import device_merkle as jdm
from stark_brainfuck_tpu_torch.convert import tensor_to_u64 as U
from stark_brainfuck_tpu_torch.convert import u64_to_tensor as T
from stark_brainfuck_tpu_torch.ops import blake2b as B
from stark_brainfuck_tpu_torch.protocol import device_merkle as tdm
from stark_brainfuck_tpu_torch.protocol.merkle import Merkle, SaltBuffer, SaltedMerkle
from stark_brainfuck_tpu_torch.protocol.stark import _salted_payload_buffer

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001

SHAPES = [
    (128, 16, 128),   # merkle parent: exactly one full block
    (128, 16, 24),    # salt PRF message
    (256, 32, 176),   # base zipped leaf + salt (19 + 3 words)
    (384, 32, 240),   # ext zipped leaf + salt (27 + 3 words)
    (128, 48, 337),   # 3-block, non-word-aligned length
]


def _make_words(n, W, msg_len, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 64, size=(n, W), dtype=np.uint64)
    nwords = (msg_len + 7) // 8
    words[:, nwords:] = 0
    if msg_len % 8:
        words[:, nwords - 1] &= np.uint64((1 << (8 * (msg_len % 8))) - 1)
    return words


def _jax_kernel_body(words, msg_len):
    """The JAX package's Pallas kernel body run on numpy refs."""
    n, W = words.shape
    rows = n // 128
    m_lo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    m_hi = (words >> np.uint64(32)).astype(np.uint32)
    ml = np.ascontiguousarray(m_lo.reshape(rows, 128, W).transpose(2, 0, 1))
    mh = np.ascontiguousarray(m_hi.reshape(rows, 128, W).transpose(2, 0, 1))
    d_lo = np.zeros((8, rows, 128), np.uint32)
    d_hi = np.zeros((8, rows, 128), np.uint32)
    with np.errstate(over="ignore"):
        _kernel_body(ml, mh, d_lo, d_hi, W=W, msg_len=msg_len, xp=np)
    d_lo = d_lo.transpose(1, 2, 0).reshape(n, 8).astype(np.uint64)
    d_hi = d_hi.transpose(1, 2, 0).reshape(n, 8).astype(np.uint64)
    return d_lo | (d_hi << np.uint64(32))


@pytest.mark.parametrize("n,W,msg_len", SHAPES)
def test_plain_blake2b_matches_hashlib_and_jax_kernel_body(n, W, msg_len):
    words = _make_words(n, W, msg_len, n + W)
    got = U(B.blake2b_words(T(words), msg_len))
    assert np.array_equal(got, _jax_kernel_body(words, msg_len))
    for i in range(0, n, 9):
        want = hashlib.blake2b(words[i].astype("<u8").tobytes()[:msg_len]).digest()
        assert got[i].astype("<u8").tobytes() == want


def test_ragged_batch_and_wrapper_checks():
    words = _make_words(5, 16, 40, 1)
    got = B.digests_to_bytes(B.blake2b_words(T(words), 40))
    for i in range(5):
        assert got[64 * i : 64 * i + 64] == hashlib.blake2b(
            words[i].astype("<u8").tobytes()[:40]
        ).digest()
    with pytest.raises(ValueError):
        B.blake2b_words(T(words), 129)  # payload past the last block
    with pytest.raises(ValueError):
        B.blake2b_words(T(words).to(torch.int32), 40)
    assert B.LAUNCHES == 0, "the CPU path must not count kernel launches"


@pytest.mark.parametrize("W,msg_len", [
    (16, 1), (16, 127), (32, 129), (32, 256), (64, 512), (64, 385),
])
def test_plain_blake2b_block_boundaries(W, msg_len):
    """Messages that just fill, or just spill into, their last block."""
    words = _make_words(128, W, msg_len, W + msg_len)
    got = U(B.blake2b_words(T(words), msg_len))
    assert np.array_equal(got, _jax_kernel_body(words, msg_len))
    for i in (0, 57, 127):
        want = hashlib.blake2b(words[i].astype("<u8").tobytes()[:msg_len]).digest()
        assert got[i].astype("<u8").tobytes() == want


@pytest.mark.parametrize("W,msg_len", [(0, 0), (8, 64), (24, 100), (16, 0),
                                       (16, 129), (32, 128), (48, 256)])
def test_wrapper_rejects_bad_shapes(W, msg_len):
    with pytest.raises(ValueError):
        B.blake2b_words(torch.zeros((4, W), dtype=torch.int64), msg_len)


def _jax_salts_as_words(key, n):
    s = jdm.salt_words(key, n, np).astype(np.uint64)  # (n, 6) u32 words
    return s[:, 0::2] | (s[:, 1::2] << np.uint64(32))


@pytest.mark.parametrize("salted", [False, True])
def test_leaf_digests_and_levels_match_jax(salted):
    rng = np.random.default_rng(11)
    n = 2048
    rows = rng.integers(0, P, size=(n, 19 if salted else 3), dtype=np.uint64)
    key = bytes(range(16))
    salts_t = tdm.salt_words_device(tdm.salt_key_words(key), n) if salted else None
    salts_j = jdm.salt_words(key, n, np) if salted else None
    for cut in (0, 2):
        want = jdm.build_levels(rows, salts_j, np, cut)
        got = tdm.build_levels(T(rows), salts_t, cut)
        assert len(want) == len(got)
        for (lo, hi), d in zip(want, got):
            assert JB.digests_to_bytes(lo, hi) == B.digests_to_bytes(d)


def test_salt_and_prf_words_match_jax():
    key = bytes(range(100, 116))
    assert np.array_equal(
        _jax_salts_as_words(key, 777),
        U(tdm.salt_words_device(tdm.salt_key_words(key), 777)),
    )
    k_lo, k_hi = jdm.salt_key_limbs(key)
    for count in (1, 8, 1001):
        want = jdm.prf_field_words(k_lo, k_hi, count, np)
        got = U(tdm.prf_field_words(tdm.salt_key_words(key), count))
        assert np.array_equal(want, got)
        assert np.all(got < np.uint64(P))


@pytest.mark.parametrize("n,salted", [(1024, False), (4096, True)])
def test_device_tree_roots_and_paths_match_host_merkle(n, salted):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, P, size=(n, 3), dtype=np.uint64)
    if salted:
        key = tdm.salt_key_words(bytes(range(16)))
        salts = tdm.salt_words_device(key, n)
        tree = tdm.DeviceSaltedMerkle(T(rows), salts)
        salt_buf = SaltBuffer(tdm.salt_words_to_buffer(salts))
        buf, plen = _salted_payload_buffer(rows, salt_buf.buf)
        host = SaltedMerkle.from_buffer(buf, plen, n, salt_buf)
    else:
        tree = tdm.DeviceMerkle(T(rows))
        host = Merkle.from_buffer(rows.astype("<u8").tobytes(), 24, n)
    assert tree.cut > 0, "the check must cover pruned bottom levels"
    assert tree.root() == host.root()
    picks = [0, 1, 63, 64, n // 2 + 5, n - 1]
    tdm.prefetch_trees([(tree, picks)])
    for i in picks:
        assert tree.open(i) == host.open(i)
        assert np.array_equal(tree.row_at(i), rows[i])


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: kernel B1 against the plain torch version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel B1 has no CPU mode)")
    # every kernel variant, full and ragged blocks of 128 messages
    for n, W, msg_len in SHAPES + [(1000, 48, 337), (1000, 16, 128),
                                   (1, 32, 240), (129, 32, 129)]:
        words = T(_make_words(n, W, msg_len, 3), "cuda")
        assert torch.equal(
            B.blake2b_words(words, msg_len), B.blake2b_words_plain(words, msg_len)
        )
