"""The port's FRI, test for test of tests/test_fri.py (the reference's
pattern): a valid low-degree codeword is accepted, a corrupted one is
rejected, and the domain's evaluate/interpolate invert each other. Proofs
equal the JAX package's bytes on the same codeword."""

import numpy as np
import torch

from stark_brainfuck_tpu.ops import field as jf
from stark_brainfuck_tpu.protocol.channel import ProofStream as JProofStream
from stark_brainfuck_tpu.protocol.fri import Fri as JFri
from stark_brainfuck_tpu.protocol.fri import FriDomain as JFriDomain
from stark_brainfuck_tpu_torch.convert import tensor_to_u64, u64_to_tensor
from stark_brainfuck_tpu_torch.ops import field as f
from stark_brainfuck_tpu_torch.protocol.channel import ProofStream, encode_leaf
from stark_brainfuck_tpu_torch.protocol.fri import Fri
from stark_brainfuck_tpu_torch.protocol.merkle import Merkle

torch.set_num_threads(1)
RNG = np.random.default_rng(23)


def make_fri(n=256, expansion=4):
    omega = f.primitive_nth_root(n)
    return Fri(f.GENERATOR, omega, n, expansion, num_colinearity_tests=8)


def jax_domain(d):
    return JFriDomain(d.offset, d.omega, d.length)


def low_degree_codeword(fri):
    n = fri.domain.length
    degree = n // fri.expansion_factor - 1
    coeffs = RNG.integers(0, f.P, size=(degree + 1, 3), dtype=np.uint64)
    cw = tensor_to_u64(fri.domain.xevaluate(u64_to_tensor(coeffs, "cpu")))
    assert np.array_equal(cw, jax_domain(fri.domain).xevaluate(coeffs))
    return cw


def prove_and_verify(cw: np.ndarray) -> bool:
    """Prove on the port's host path, check the bytes against the JAX
    package's numpy prover, and verify against the codeword's root."""
    fri = make_fri()
    ps = ProofStream()
    fri.prove(u64_to_tensor(cw, "cpu"), ps, on_device=False)
    proof = ps.serialize()
    jfri = JFri(jf.GENERATOR, jf.primitive_nth_root(256), 256, 4,
                num_colinearity_tests=8)
    jps = JProofStream()
    jfri.prove(cw, jps)
    assert proof == jps.serialize()
    root = Merkle(
        [encode_leaf(tuple(int(v) for v in row)) for row in cw]
    ).root()
    return fri.verify(ProofStream.deserialize(proof), root)


def test_fri_accepts_low_degree():
    assert prove_and_verify(low_degree_codeword(make_fri()))


def test_fri_rejects_high_degree():
    # full-degree random codeword: exceeds the rate bound
    cw = RNG.integers(0, f.P, size=(256, 3), dtype=np.uint64)
    assert not prove_and_verify(cw)


def test_fri_rejects_corrupted_low_order_coeffs():
    """The reference's corruption pattern: zero a few values after
    evaluation tampers the codeword (ref test_fri.py:30-59)."""
    cw = low_degree_codeword(make_fri()).copy()
    cw[:4] = 0  # pointwise corruption
    assert not prove_and_verify(cw)


def test_domain_base_evaluate_interpolate_roundtrip():
    """FriDomain.evaluate/interpolate (base-field variants, ref fri.py:26-37)
    invert each other, agree with naive pointwise evaluation, and equal the
    JAX package's FriDomain on the same coefficients."""
    d = make_fri(n=64).domain
    coeffs = RNG.integers(0, f.P, size=(17,), dtype=np.uint64)
    values = tensor_to_u64(d.evaluate(u64_to_tensor(coeffs, "cpu")))
    assert np.array_equal(values, jax_domain(d).evaluate(coeffs))
    # naive check at a few points
    for i in [0, 1, 5, 63]:
        x = d(i)
        acc, xp_pow = 0, 1
        for c in coeffs:
            acc = (acc + int(c) * xp_pow) % f.P
            xp_pow = (xp_pow * x) % f.P
        assert int(values[i]) == acc
    back = tensor_to_u64(d.interpolate(u64_to_tensor(values, "cpu")))
    assert np.array_equal(back, jax_domain(d).interpolate(values))
    assert np.all(back[:17] == coeffs) and np.all(back[17:] == 0)
