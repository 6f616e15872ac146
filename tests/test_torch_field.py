"""Torch port field layer vs the JAX package's numpy path, exact equality.

Inputs are seeded numpy u64 arrays plus the edge values 0, 1, p-1,
2^32±1 and 2^63 (reduced mod p where an op needs canonical inputs); both
sides get the same inputs and must agree bit for bit."""

import numpy as np
import pytest
import torch

from stark_brainfuck_tpu.ops import field as jf
from stark_brainfuck_tpu.ops import xfield as jxf
from stark_brainfuck_tpu_torch.convert import tensor_to_u64 as U
from stark_brainfuck_tpu_torch.convert import u64_to_tensor as T
from stark_brainfuck_tpu_torch.ops import field as tf
from stark_brainfuck_tpu_torch.ops import xfield as txf

torch.set_num_threads(1)

P = jf.P
EDGES = np.array(
    [0, 1, P - 1, 2**32 - 1, 2**32, 2**32 + 1, 2**63 % P, P - 2],
    dtype=np.uint64,
)


def _operands(seed, n=2000):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=n, dtype=np.uint64)
    b = rng.integers(0, P, size=n, dtype=np.uint64)
    ea, eb = np.meshgrid(EDGES, EDGES)
    return np.concatenate([a, ea.ravel()]), np.concatenate([b, eb.ravel()])


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match(op):
    a, b = _operands(1)
    want = getattr(jf, op)(a, b, np)
    got = U(getattr(tf, op)(T(a), T(b)))
    assert np.array_equal(want, got)


def test_neg_and_reduce128_match():
    a, _ = _operands(2)
    assert np.array_equal(jf.neg(a, np), U(tf.neg(T(a))))
    rng = np.random.default_rng(3)
    hi = np.concatenate(
        [rng.integers(0, 2**64, 500, dtype=np.uint64),
         np.array([0, 2**64 - 1, 2**63, P], dtype=np.uint64)]
    )
    lo = np.concatenate(
        [rng.integers(0, 2**64, 500, dtype=np.uint64),
         np.array([2**64 - 1, 0, P - 1, P], dtype=np.uint64)]
    )
    assert np.array_equal(jf.reduce128(hi, lo, np), U(tf.reduce128(T(hi), T(lo))))


def test_mod_p_of_full_words():
    words = np.array([0, P - 1, P, P + 1, 2**63, 2**64 - 1], dtype=np.uint64)
    want = np.array([int(w) % P for w in words], dtype=np.uint64)
    assert np.array_equal(want, U(tf.from_u64_mod_p(T(words))))


def test_batch_inverse_and_pow_match():
    a, _ = _operands(4, n=300)
    a = a[a != 0]
    inv = U(tf.batch_inverse(T(a)))
    assert np.array_equal(jf.batch_inverse(a, np), inv)
    assert np.all(jf.mul(a, inv, np) == 1)
    assert np.array_equal(jf.pow_const(a, 12345, np), U(tf.pow_const(T(a), 12345)))


@pytest.mark.parametrize("count", [1, 2, 37, 256])
def test_geometric_rows_and_powers_match(count):
    rng = np.random.default_rng(count)
    starts = np.concatenate([rng.integers(0, P, 4, dtype=np.uint64), EDGES[:3]])
    ratios = np.concatenate([rng.integers(0, P, 4, dtype=np.uint64), EDGES[-3:]])
    want = jf.geometric_rows(starts, ratios, count, np)
    assert np.array_equal(want, U(tf.geometric_rows(T(starts), T(ratios), count)))
    assert np.array_equal(jf.powers(987654321, count, np), U(tf.powers(987654321, count)))


def test_xfield_ops_match():
    a, b = _operands(5, n=1500)
    x = a[: 3 * (len(a) // 3)].reshape(-1, 3)
    y = b[: 3 * (len(b) // 3)].reshape(-1, 3)
    assert np.array_equal(jxf.mul(x, y, np), U(txf.mul(T(x), T(y))))
    assert np.array_equal(jxf.mul_base(x, y[:, 0], np), U(txf.mul_base(T(x), T(y[:, 0]))))
    nz = x[np.any(x != 0, axis=1)]
    assert np.array_equal(jxf.inverse(nz, np), U(txf.inverse(T(nz))))
    assert np.array_equal(jxf.pow_const(x, 77, np), U(txf.pow_const(T(x), 77)))


def test_host_helpers_match():
    rng = np.random.default_rng(6)
    for _ in range(50):
        a = tuple(int(v) for v in rng.integers(0, P, 3, dtype=np.uint64))
        b = tuple(int(v) for v in rng.integers(0, P, 3, dtype=np.uint64))
        assert txf.h_mul(a, b) == jxf.h_mul(a, b)
        assert txf.h_inverse(a) == jxf.h_inverse(a)
        assert tf.h_inverse(a[0] or 1) == jf.h_inverse(a[0] or 1)
    assert tf.primitive_nth_root(1 << 20) == jf.primitive_nth_root(1 << 20)
    blob = bytes(range(48))
    assert txf.h_sample(blob) == jxf.h_sample(blob)


def test_convert_round_trips_bits():
    from stark_brainfuck_tpu import VirtualMachine
    from stark_brainfuck_tpu_torch.convert import to_i64, trace_to_tensors

    words = np.array([0, 1, 2**63 - 1, 2**63, P, 2**64 - 1], dtype=np.uint64)
    t = T(words)
    assert t.dtype == torch.int64
    assert np.array_equal(U(t), words)
    assert [to_i64(int(w)) for w in words] == t.tolist()
    trace = VirtualMachine.simulate(VirtualMachine.compile(",+."), "a")
    tensors = trace_to_tensors(trace)
    assert set(tensors) == {"processor", "memory", "instruction", "input", "output"}
    for k, v in tensors.items():
        assert np.array_equal(U(v), trace[k])
