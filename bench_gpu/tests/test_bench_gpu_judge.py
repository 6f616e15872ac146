"""The plain reference judges a tiny proof of the program on the CPU: the
same bytes pass, a tampered proof does not."""

import pytest

import bench_gpu_tiny as T  # noqa: F401
import judge

import stark_brainfuck_tpu_torch as P

SOURCE = "+++[->++[-]<]"
STARK = {"log_expansion_factor": 2, "security_level": 2,
         "num_randomizers": 1, "codec": "native"}


def program_proof(seed, stark=STARK):
    program = P.VirtualMachine.compile(SOURCE)
    trace = P.VirtualMachine.simulate(program)
    prover = P.BrainfuckStark(trace["processor"].shape[0],
                              trace["memory"].shape[0], program, "",
                              trace["output_data"],
                              P.StarkConfig(seed=seed, **stark),
                              device="cpu")
    return prover.prove(trace["processor"], trace["memory"],
                        trace["instruction"], trace["input"], trace["output"])


@pytest.fixture(scope="module")
def pair():
    return (program_proof(2**33 + 1),
            judge.reference_proof(SOURCE, "", 2**33 + 1, STARK, "cpu"))


def test_same_bytes(pair):
    got, want = pair
    assert judge.bytes_differing(got, want) == 0


@pytest.mark.parametrize("where", [0, 100, -1])
def test_a_flipped_byte_is_found(pair, where):
    got, want = pair
    bad = bytearray(got)
    bad[where] ^= 0x01
    assert judge.bytes_differing(bytes(bad), want) == 1


def test_a_cut_proof_is_found(pair):
    got, want = pair
    assert judge.bytes_differing(got[:-7], want) == 7


@pytest.mark.parametrize("stark, knobs", [
    (dict(STARK, log_expansion_factor=5, security_level=160), {}),
    (STARK, {"stream_min": 1, "stream_classes": 4}),
    (STARK, {"ntt_backend": "mxu"}),
])
def test_same_bytes_on_other_paths(stark, knobs):
    """The security-160 parameters, and the port's streamed prover and its
    other NTT route, against the reference's one resident path."""
    got = program_proof(2**33 + 3, dict(stark, **knobs))
    want = judge.reference_proof(SOURCE, "", 2**33 + 3, stark, "cpu")
    assert judge.bytes_differing(got, want) == 0


def test_weighing_fewer_terms_at_a_time_keeps_the_bytes(pair, monkeypatch):
    """The reference's combination weighed one term at a time, as at large
    domains, gives the same proof."""
    from reference.bfstark.protocol import stark as RS

    monkeypatch.setattr(RS, "ACC_CHUNK_ELEMENTS", 1)
    got, _ = pair
    want = judge.reference_proof(SOURCE, "", 2**33 + 1, STARK, "cpu")
    assert judge.bytes_differing(got, want) == 0


def test_another_seed_differs(pair):
    _, want = pair
    assert judge.bytes_differing(program_proof(2**33 + 2), want) > 1000


def test_sample_is_drawn_from_the_seed():
    a = judge.sample(3, 200, 2**31 + 9)
    assert a == judge.sample(3, 200, 2**31 + 9)
    assert len(set(a)) == 3 and all(0 <= i < 200 for i in a)
    assert a != judge.sample(3, 200, 2**31 + 10)
    assert judge.sample(3, 2, 5) == [0, 1]


@pytest.mark.parametrize("first", [0, 57, 199])
def test_sample_always_holds_the_first_named(first):
    a = judge.sample(6, 200, 2**31 + 9, first=first)
    assert first in a and len(set(a)) == 6
    assert a == judge.sample(6, 200, 2**31 + 9, first=first)
    assert judge.sample(1, 200, 7, first=first) == [first]
    assert judge.sample(6, 3, 7, first=1) == [0, 1, 2]
