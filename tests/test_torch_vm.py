"""The port's VM, test for test of tests/test_vm.py: compile, run and
simulate semantics; each test that records a trace runs on both recorders
(the C++ one, `native=True`, and the python one), and the trace is held to
the JAX package's."""

import io

import numpy as np
import pytest

from stark_brainfuck_tpu import VirtualMachine as JVM
from stark_brainfuck_tpu_torch.vm.machine import VirtualMachine

HELLO = (
    "++++++++[>++++[>++>+++>+++>+<<<<-]>+>+>->>+[<]<-]>>.>---.+++++++.."
    "+++.>>.<-.<.+++.------.--------.>>+.>++."
)
RECORDERS = pytest.mark.parametrize("native", [True, False],
                                    ids=["cpp", "python"])


def test_compile_jump_targets():
    program = VirtualMachine.compile("+[>+<-]+")
    # `+[9>+<-]3+`: loop ends recorded inline
    assert program == [ord("+"), ord("["), 9, ord(">"), ord("+"), ord("<"),
                       ord("-"), ord("]"), 3, ord("+")]
    assert program == JVM.compile("+[>+<-]+")


def test_run_hello_world():
    program = VirtualMachine.compile(HELLO)
    rt, inp, out = VirtualMachine.run(program)
    assert out == "Hello World!\n"
    assert rt > len(HELLO)


def test_run_with_input():
    program = VirtualMachine.compile(",+.")
    rt, inp, out = VirtualMachine.run(program, "a")
    assert out == "b"


@RECORDERS
def test_simulate_matches_run(native):
    program = VirtualMachine.compile("++>+<[->+<]")
    rt, _, out = VirtualMachine.run(program)
    trace = VirtualMachine.simulate(program, native=native)
    assert trace["processor"].shape[0] == rt
    assert trace["output_data"] == out
    # instruction matrix = program rows + one per cycle, sorted by address
    assert trace["instruction"].shape[0] == rt + len(program)
    addrs = trace["instruction"][:, 0]
    assert np.all(addrs[:-1] <= addrs[1:])


@RECORDERS
def test_simulate_matches_reference(native):
    """The JAX package's recorder stands for the reference here (its own
    test holds it to the reference implementation)."""
    for src, inp in [("++++", ""), ("++>+<[->+<]", ""), (",+.", "a"),
                     (HELLO, "")]:
        program = VirtualMachine.compile(src)
        assert program == JVM.compile(src)
        trace = VirtualMachine.simulate(program, inp, native=native)
        want = JVM.simulate(program, inp, native=False)
        for key in ("processor", "memory", "instruction", "input", "output"):
            assert trace[key].tolist() == want[key].tolist(), (src, key)
        assert trace["output_data"] == want["output_data"]


@RECORDERS
def test_memory_matrix_dummy_rows(native):
    # program with a clk gap for a revisited cell
    program = VirtualMachine.compile("+>++<-")
    trace = VirtualMachine.simulate(program, native=native)
    mem = trace["memory"]
    assert mem[:, 3].any(), "no dummy row was inserted"
    # dummy rows fill clk gaps within each mp group
    for i in range(len(mem) - 1):
        if mem[i][1] == mem[i + 1][1]:
            assert int(mem[i + 1][0]) == int(mem[i][0]) + 1


def test_run_interactive_stdin_fallback(monkeypatch):
    """',' past the provided input falls back to live stdin (the
    reference's _Getch behavior, ref vm.py:13-54,151-158); the returned
    input string includes the interactively-consumed characters."""
    monkeypatch.setattr("sys.stdin", io.StringIO("zq"))
    program = VirtualMachine.compile(",.,.")
    rt, consumed, out = VirtualMachine.run(program, "")
    assert out == "zq"
    assert consumed == "zq"

    # exhausted stdin raises EOFError instead of asserting
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    with pytest.raises(EOFError):
        VirtualMachine.run(VirtualMachine.compile(","), "")
