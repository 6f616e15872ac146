"""Brainfuck compiler, runner, and trace-recording simulator.

Semantics match the reference VM (`vm.py:70-306`):

  - `compile` inserts jump-target operands after `[` / `]` so the AIR can
    treat control flow as data (ref vm.py:78-105);
  - `run` executes and returns (running_time, input_data, output_data)
    (ref vm.py:107-165);
  - `simulate` re-executes while recording the algebraic execution trace:
    processor matrix (7 registers/row), instruction matrix (program rows +
    one row per cycle, sorted by address), input/output symbol matrices, and
    the derived memory matrix (ref vm.py:172-306).

Implementation is host-side: matrices are emitted as numpy uint64 arrays,
which the prover moves to the device as int64 tensors (convert.py). Memory
is a flat python dict from pointer (int mod p) to value, as cells are
unbounded ints mod p in the reference semantics.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ops.field import P

U64 = np.uint64

# processor column indices (ref processor_table.py:6-12)
CLK, IP, CI, NI, MP, MV, MVI = range(7)


def _read_char_interactive() -> str:
    """One character from live stdin: raw single-key read on a tty (the
    reference's `_Getch`, ref vm.py:13-54), buffered read(1) otherwise
    (pipes, tests). Raises EOFError when no input can be had."""
    import sys

    if sys.stdin is None or sys.stdin.closed:
        raise EOFError("input exhausted and no stdin available")
    if sys.stdin.isatty():
        try:
            import termios
            import tty

            fd = sys.stdin.fileno()
            old = termios.tcgetattr(fd)
            try:
                tty.setraw(fd)
                ch = sys.stdin.read(1)
            finally:
                termios.tcsetattr(fd, termios.TCSADRAIN, old)
            if ch:
                return ch
            raise EOFError("input exhausted and stdin at EOF")
        except (ImportError, OSError):
            pass
    ch = sys.stdin.read(1)
    if ch == "":
        raise EOFError("input exhausted and stdin at EOF")
    return ch


def _inv(v: int) -> int:
    return pow(v, P - 2, P) if v else 0


class VirtualMachine:
    @staticmethod
    def compile(brainfuck_code: str) -> List[int]:
        """Brainfuck -> 'assembler' with inline jump targets.

        `+[>+<-]+` compiles to `+[9>+<-]3+` (positions recorded after each
        bracket), as in ref vm.py:78-105."""
        program: List[int] = []
        stack: List[int] = []
        for symbol in brainfuck_code:
            program.append(ord(symbol))
            if symbol == "[":
                program.append(0)  # patched when the matching ] is seen
                stack.append(len(program) - 1)
            elif symbol == "]":
                program.append(stack[-1] + 1)
                program[stack[-1]] = len(program)
                stack.pop()
        assert not stack, "unbalanced brackets"
        return program

    @staticmethod
    def run(
        program: List[int], input_data: str = ""
    ) -> Tuple[int, str, str]:
        """Plain execution (no trace). Returns (running_time, input, output).

        When a ',' executes past the end of `input_data`, falls back to
        reading live from stdin — raw getch on a tty, buffered otherwise —
        matching the reference's interactive `_Getch` behavior
        (ref vm.py:13-54,151-158). The returned input string includes any
        interactively-consumed characters, so the run is replayable."""
        ip = 0
        mp = 0
        memory = {}
        out: List[str] = []
        in_ptr = 0
        running_time = 1
        n = len(program)
        while ip < n:
            op = program[ip]
            if op == ord("["):
                if memory.get(mp, 0) == 0:
                    ip = program[ip + 1]
                else:
                    ip += 2
            elif op == ord("]"):
                if memory.get(mp, 0) != 0:
                    ip = program[ip + 1]
                else:
                    ip += 2
            elif op == ord("<"):
                ip += 1
                mp = (mp - 1) % P
            elif op == ord(">"):
                ip += 1
                mp = (mp + 1) % P
            elif op == ord("+"):
                ip += 1
                memory[mp] = (memory.get(mp, 0) + 1) % P
            elif op == ord("-"):
                ip += 1
                memory[mp] = (memory.get(mp, 0) - 1) % P
            elif op == ord("."):
                ip += 1
                out.append(chr(memory.get(mp, 0) % 256))
            elif op == ord(","):
                ip += 1
                if in_ptr >= len(input_data):
                    input_data = input_data + _read_char_interactive()
                memory[mp] = ord(input_data[in_ptr])
                in_ptr += 1
            else:
                raise AssertionError(f"unrecognized instruction at {ip}: {op}")
            running_time += 1
        return running_time, input_data, "".join(out)

    @staticmethod
    def simulate(program: List[int], input_data: str = ""):
        """Execute while recording the algebraic execution trace (the port's
        python recorder, the plain version its C++ recorder is held to).

        Returns a dict of numpy uint64 matrices:
          processor   (T+1, 7)  — clk, ip, ci, ni, mp, mv, mvi per cycle
          memory      (M, 4)    — clk, mp, mv, dummy (sorted, dummy-filled)
          instruction (T+1+|program|, 3) — addr, ci, ni, sorted by addr
          input       (I, 1), output (O, 1)
        plus output_data string.
        """
        return _simulate_python(program, input_data)


def _simulate_python(program: List[int], input_data: str):
    """The python recorder."""
    n = len(program)
    ip = 0
    mp = 0
    mv = 0
    mvi = 0
    clk = 0
    ci = program[0] if n > 0 else 0
    ni = program[1] if n > 1 else 0
    memory = {}
    in_ptr = 0
    out_chars: List[str] = []

    processor_rows: List[Tuple[int, ...]] = []
    instruction_rows: List[Tuple[int, int, int]] = [
        (i, program[i], program[i + 1] if i + 1 < n else 0) for i in range(n)
    ]
    input_rows: List[int] = []
    output_rows: List[int] = []

    while ip < n:
        processor_rows.append((clk, ip, ci, ni, mp, mv, mvi))
        instruction_rows.append((ip, ci, ni))

        if ci == ord("["):
            ip = program[ip + 1] if mv == 0 else ip + 2
        elif ci == ord("]"):
            ip = program[ip + 1] if mv != 0 else ip + 2
        elif ci == ord("<"):
            ip += 1
            mp = (mp - 1) % P
        elif ci == ord(">"):
            ip += 1
            mp = (mp + 1) % P
        elif ci == ord("+"):
            ip += 1
            memory[mp] = (memory.get(mp, 0) + 1) % P
        elif ci == ord("-"):
            ip += 1
            memory[mp] = (memory.get(mp, 0) - 1) % P
        elif ci == ord("."):
            ip += 1
            val = memory.get(mp, 0)
            output_rows.append(val)
            out_chars.append(chr(val % 256))
        elif ci == ord(","):
            ip += 1
            assert in_ptr < len(input_data), "input exhausted"
            memory[mp] = ord(input_data[in_ptr])
            in_ptr += 1
            input_rows.append(memory[mp])
        else:
            raise AssertionError(f"unrecognized instruction at ip={ip}: {ci}")

        clk += 1
        ci = program[ip] if ip < n else 0
        ni = program[ip + 1] if ip < n - 1 else 0
        mv = memory.get(mp, 0)
        mvi = _inv(mv)

    processor_rows.append((clk, ip, ci, ni, mp, mv, mvi))
    instruction_rows.append((ip, ci, ni))
    instruction_rows.sort(key=lambda r: r[0])

    processor = np.array(processor_rows, dtype=U64).reshape(-1, 7)
    instruction = np.array(instruction_rows, dtype=U64).reshape(-1, 3)
    memory_matrix = derive_memory_matrix(processor)
    inp = np.array(input_rows, dtype=U64).reshape(-1, 1)
    outp = np.array(output_rows, dtype=U64).reshape(-1, 1)

    return {
        "processor": processor,
        "memory": memory_matrix,
        "instruction": instruction,
        "input": inp,
        "output": outp,
        "output_data": "".join(out_chars),
    }


def derive_memory_matrix(processor: np.ndarray) -> np.ndarray:
    """Sort non-padding processor rows by (mp, clk) and insert dummy rows so
    consecutive equal-mp rows have contiguous clk — the defense against the
    sorting attack (ref memory_table.py:20-38, docs/attack.md).

    Columns: clk, mp, mv, dummy."""
    rows = processor[processor[:, CI] != 0]
    sel = rows[:, [CLK, MP, MV]].astype(object)
    order = np.lexsort((rows[:, CLK].astype(np.int64), _sort_key(rows[:, MP])))
    sel = sel[order]

    out: List[Tuple[int, int, int, int]] = []
    for clk, mp, mv in sel:
        clk, mp, mv = int(clk), int(mp), int(mv)
        if out and out[-1][1] == mp and clk != out[-1][0] + 1:
            # fill the clk gap with dummy rows
            gap_clk = out[-1][0] + 1
            while gap_clk != clk:
                out.append((gap_clk, mp, out[-1][2], 1))
                gap_clk += 1
        out.append((clk, mp, mv, 0))
    return np.array(out, dtype=U64).reshape(-1, 4)


def _sort_key(mp_col: np.ndarray) -> np.ndarray:
    """Sort memory pointers by integer value (field elements as 0..p-1,
    matching the reference's `.value`-keyed sort, memory_table.py:28)."""
    return mp_col  # uint64 sorts by value directly
