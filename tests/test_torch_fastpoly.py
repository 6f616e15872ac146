"""The port's fast polynomial algorithms (`ops/fastpoly.py`, on int64
tensors) element for element against the JAX package's (`xp=np`), on the
cases of tests/test_fastpoly.py with inputs drawn from a numpy seed, plus
the properties that file checks (schoolbook product, vanishing, round
trips). Tolerance: none, the integers must be equal."""

import numpy as np
import pytest
import torch

from stark_brainfuck_tpu.ops import fastpoly as jfp
from stark_brainfuck_tpu_torch.convert import tensor_to_u64, u64_to_tensor
from stark_brainfuck_tpu_torch.ops import fastpoly as fp
from stark_brainfuck_tpu_torch.ops import field as f
from stark_brainfuck_tpu_torch.ops import poly as hp

torch.set_num_threads(1)


def _rng(*case):
    return np.random.default_rng([5, *case])


def rand_coeffs(rng, n):
    return rng.integers(0, f.P, size=(n,), dtype=np.uint64)


def rand_points(rng, n):
    out, seen = [], set()
    while len(out) < n:
        v = int(rng.integers(0, f.P, dtype=np.uint64))
        if v not in seen:
            seen.add(v)
            out.append(v)
    return np.asarray(out, dtype=np.uint64)


def ints(x):
    if isinstance(x, torch.Tensor):
        x = tensor_to_u64(x)
    return [int(v) for v in np.asarray(x).reshape(-1)]


@pytest.mark.parametrize("la,lb", [(5, 3), (16, 16), (33, 20), (1, 7)])
def test_fast_multiply_matches_schoolbook(la, lb):
    rng = _rng(la, lb)
    a, b = rand_coeffs(rng, la), rand_coeffs(rng, lb)
    got = fp.fast_multiply(a, b, device="cpu")
    assert ints(got) == ints(jfp.fast_multiply(a, b, np))
    want = hp.mul([int(v) for v in a], [int(v) for v in b])
    assert ints(got) == want


def test_fast_multiply_batched_and_on_a_device_tensor():
    rng = _rng(99)
    a, b = rand_coeffs(rng, 12).reshape(3, 4), rand_coeffs(rng, 15).reshape(3, 5)
    got = fp.fast_multiply(u64_to_tensor(a), u64_to_tensor(b), device="cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == (3, 8)
    assert ints(got) == ints(jfp.fast_multiply(a, b, np))
    assert ints(fp.fast_multiply(a[:, :0], b, device="cpu")) == []


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 13, 32])
def test_fast_zerofier(n):
    pts = rand_points(_rng(n), n)
    got = ints(fp.fast_zerofier(pts, device="cpu"))
    assert got == ints(jfp.fast_zerofier(pts, np))
    assert got == hp.zerofier([int(v) for v in pts])


@pytest.mark.parametrize("deg,npts", [(7, 5), (20, 33), (0, 4), (15, 16)])
def test_fast_evaluate(deg, npts):
    rng = _rng(deg, npts)
    coeffs = rand_coeffs(rng, deg + 1)
    pts = rand_points(rng, npts)
    got = ints(fp.fast_evaluate(coeffs, pts, device="cpu"))
    assert got == ints(jfp.fast_evaluate(coeffs, pts, np))
    assert got == [hp.evaluate([int(v) for v in coeffs], int(x)) for x in pts]


@pytest.mark.parametrize("n", [2, 3, 8, 21])
def test_fast_interpolate(n):
    rng = _rng(n, 1)
    pts = rand_points(rng, n)
    vals = rand_coeffs(rng, n)
    got = fp.fast_interpolate(pts, vals, device="cpu")
    assert ints(got) == ints(jfp.fast_interpolate(pts, vals, np))
    # the interpolant hits every point and has degree < n
    assert ints(fp.fast_evaluate(got, pts, device="cpu")) == ints(vals)
    assert got.shape[0] == n
    want = hp.interpolate([int(v) for v in pts], [int(v) for v in vals])
    assert ints(got) == want + [0] * (n - len(want))


@pytest.mark.parametrize("qdeg,bdeg", [(5, 3), (12, 1), (20, 20)])
def test_fast_coset_divide_exact(qdeg, bdeg):
    rng = _rng(qdeg, bdeg, 2)
    q = rand_coeffs(rng, qdeg + 1)
    b = rand_coeffs(rng, bdeg + 1)
    b[-1] = 1  # monic, nonzero
    a = tensor_to_u64(fp.fast_multiply(q, b, device="cpu"))
    args = (f.GENERATOR, f.primitive_nth_root(64), 64)
    got = fp.fast_coset_divide(a, b, *args, device="cpu")
    assert ints(got) == ints(jfp.fast_coset_divide(a, b, *args, np))
    assert ints(got[: qdeg + 1]) == ints(q)


@pytest.mark.parametrize("d,length", [(5, 8), (32, 32), (40, 256)])
def test_fast_coset_evaluate(d, length):
    coeffs = rand_coeffs(_rng(d, length), d)
    args = (f.GENERATOR, f.primitive_nth_root(length), length)
    got = fp.fast_coset_evaluate(coeffs, *args, device="cpu")
    assert ints(got) == ints(jfp.fast_coset_evaluate(coeffs, *args, np))
    xs = [f.h_mul(args[0], f.h_pow(args[1], i)) for i in range(0, length, 7)]
    assert ints(got)[::7] == [hp.evaluate(ints(coeffs), x) for x in xs]


def test_host_arrays_go_to_the_card_unless_the_cpu_is_named():
    """As every entry point of the port: a numpy input without a device
    goes to CUDA and raises without a card; a tensor stays where it is."""
    a = rand_coeffs(_rng(7), 4)
    if torch.cuda.is_available():
        assert fp.fast_multiply(a, a).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            fp.fast_multiply(a, a)
    assert fp.fast_multiply(u64_to_tensor(a), a).device.type == "cpu"


def test_empty_inputs_match_jax():
    empty = np.zeros((0,), dtype=np.uint64)
    pts = rand_points(_rng(0), 3)
    for name, args in (("fast_zerofier", (empty,)),
                       ("fast_evaluate", (rand_coeffs(_rng(1), 4), empty)),
                       ("fast_interpolate", (empty, empty))):
        assert ints(getattr(fp, name)(*args, device="cpu")) == ints(
            getattr(jfp, name)(*args, np)), name
    assert ints(fp.fast_evaluate(empty, pts, device="cpu")) == ints(
        jfp.fast_evaluate(empty, pts, np)) == [0, 0, 0]
