"""Kernel F4 (`csrc/quotients.cu`): each table's AIR quotients in one launch.

The JAX package stages each table's `_table_quotient_stack` as one jitted
executable (`comb_quot{ti}`), whose constraint expression XLA fuses. The
port's counterpart is F4, whose body is generated here from the models:

  - `program(table)` records `Table.quotients` with `ProgramAlgebra`
    (`models/interp.py`) as a straight-line program over the row's and the
    next row's columns, the challenges, terminals and exponents;
  - `lower` folds its constants (x + 0, x·1, x·0 and constant operands:
    field arithmetic is exact, so no bit changes), merges common
    subexpressions, drops dead nodes, and splits off the values that depend
    on no column (`uniform`: computed once a block);
  - `emit` writes the five tables' lowered programs as straight-line C++
    into `csrc/quotients_gen.cuh`, which is committed:

        python -m stark_brainfuck_tpu_torch.ops.quotient_kernels --emit

    (a tier-1 test holds the committed file to a fresh emit);
  - `quotient_stack` launches F4 on CUDA operands and returns the (T, n, 3)
    stack that F3 consumes; `host_stack` runs the same generated body
    compiled with g++ (`native/quotients_host.cpp`), for the tests.

Each launch carries its program's key (`Program.key`); the library refuses
a key it was not generated from, so a stale emit raises instead of
computing other constraints. Nothing here builds or launches at import.
"""

from __future__ import annotations

import argparse
import ctypes
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models.interp import ZEROFIERS, Program, ProgramAlgebra
from . import cuda_build
from . import field as f
from . import xfield as xf
from .field_kernels import _on, _stream, card_device

# launches of F4 since import (or since a caller reset it)
LAUNCHES_QUOTIENT = 0

# the prover's tables, in the order of `BrainfuckStark.tables`: the index is
# csrc/quotients.cu's `table` argument
TABLES = ("processor", "instruction", "memory", "input", "output")
# csrc/quotients.cuh's codes for arguments the compiled program does not take
BAD_TABLE, BAD_KEY, BAD_SHAPE = -1, -2, -3

GEN_PATH = os.path.join(cuda_build.CSRC_DIR, "quotients_gen.cuh")
EMIT_COMMAND = "python -m stark_brainfuck_tpu_torch.ops.quotient_kernels --emit"

_LIB = None
_HOST_LIB = None


def template_tables():
    """One table of each kind, in TABLES order, to record programs from
    (a program depends on the class, not on the instance's sizes)."""
    from ..models.instruction import InstructionTable
    from ..models.io import InputTable, OutputTable
    from ..models.memory import MemoryTable
    from ..models.processor import ProcessorTable

    return [ProcessorTable(1, 1), InstructionTable(1, 1), MemoryTable(1, 1),
            InputTable(1), OutputTable(1)]


def program(table) -> Program:
    """`table.quotients` recorded as a program, with the instance's
    exponents in `params`."""
    return ProgramAlgebra.record(table)


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------


class Lowered:
    """A program after folding, merging and dead-node removal.

    `nodes[k]` = (op, ext, args): op as in `Program` ("base", "ext", "ch",
    "tm", "add", "sub", "mul", "neg", "pow"); for loads, challenges and
    terminals args is the program's (c, nxt) or (k,), for "pow" (operand,
    slot), else the operands, each ("n", node) or ("c", value, ext) for a
    constant. `outputs` lists (operand, zerofier kind). `uniform[k]` says
    node k depends on no column."""

    def __init__(self, prog: Program):
        self.program = prog
        self.nodes: List[tuple] = []
        self.outputs: List[Tuple[tuple, str]] = []
        self.uniform: List[bool] = []


def _lift(v):
    return v if isinstance(v, tuple) else (v, 0, 0)


def _fold(op: str, a, b, ext: bool):
    """The constant result of op on constant values (base ints or
    extension 3-tuples)."""
    P = f.P
    if op == "neg":
        return xf.h_neg(_lift(a)) if ext else (-a) % P
    if not ext:
        return {"add": a + b, "sub": a - b, "mul": a * b}[op] % P
    fn = {"add": xf.h_add, "sub": xf.h_sub, "mul": xf.h_mul}[op]
    return fn(_lift(a), _lift(b))


def _is_const(v, value: int) -> bool:
    return v[0] == "c" and _lift(v[1]) == (value, 0, 0)


def lower(prog: Program) -> Lowered:
    """Constants folded, common subexpressions merged (add and mul taken as
    commutative), nodes no output needs dropped."""
    out = Lowered(prog)
    rep: List[tuple] = []
    memo: Dict[tuple, int] = {}

    def node(op, ext, args) -> tuple:
        key = (op, ext, args)
        if key not in memo:
            memo[key] = len(out.nodes)
            out.nodes.append((op, ext, args))
        return ("n", memo[key])

    def typed(v) -> bool:
        return v[2] if v[0] == "c" else out.nodes[v[1]][1]

    for op, ext in zip(prog.ops, prog.ext):
        kind = op[0]
        if kind == "const":
            rep.append(("c", op[1], ext))
        elif kind in ("base", "ext", "ch", "tm"):
            rep.append(node(kind, ext, op[1:]))
        elif kind == "neg":
            a = rep[op[1]]
            rep.append(("c", _fold("neg", a[1], None, ext), ext)
                       if a[0] == "c" else node("neg", ext, (a,)))
        elif kind == "pow":
            rep.append(node("pow", ext, (rep[op[1]], op[2])))
        else:
            a, b = rep[op[1]], rep[op[2]]
            if a[0] == "c" and b[0] == "c":
                rep.append(("c", _fold(kind, a[1], b[1], ext), ext))
                continue
            # an identity leaves the other operand, where its type is the
            # result's
            if kind == "mul" and (_is_const(a, 0) or _is_const(b, 0)):
                rep.append(("c", (0, 0, 0) if ext else 0, ext))
                continue
            keep = None
            if kind == "add" and _is_const(a, 0):
                keep = b
            elif kind in ("add", "sub") and _is_const(b, 0):
                keep = a
            elif kind == "mul" and _is_const(a, 1):
                keep = b
            elif kind == "mul" and _is_const(b, 1):
                keep = a
            if keep is not None and typed(keep) == ext:
                rep.append(keep)
                continue
            if kind in ("add", "mul") and repr(b) < repr(a):
                a, b = b, a
            rep.append(node(kind, ext, (a, b)))
    outputs = [(rep[n], kind) for n, kind in prog.outputs]

    # dead nodes out, renumbered in order
    live = [False] * len(out.nodes)
    stack = [v[1] for v, _ in outputs if v[0] == "n"]
    while stack:
        k = stack.pop()
        if live[k]:
            continue
        live[k] = True
        op, _, args = out.nodes[k]
        if op in ("add", "sub", "mul", "neg", "pow"):
            stack += [a[1] for a in args if isinstance(a, tuple)
                      and a[0] == "n"]
    index, nodes = {}, []

    def renum(v):
        return ("n", index[v[1]]) if v[0] == "n" else v

    for k, (op, ext, args) in enumerate(out.nodes):
        if not live[k]:
            continue
        if op in ("add", "sub", "mul", "neg"):
            args = tuple(renum(a) for a in args)
        elif op == "pow":
            args = (renum(args[0]), args[1])
        index[k] = len(nodes)
        nodes.append((op, ext, args))
    out.nodes = nodes
    out.outputs = [(renum(v), kind) for v, kind in outputs]
    for op, _, args in nodes:
        if op in ("base", "ext"):
            out.uniform.append(False)
        elif op in ("ch", "tm"):
            out.uniform.append(True)
        else:
            out.uniform.append(all(
                a[0] == "c" or out.uniform[a[1]]
                for a in (args[:1] if op == "pow" else args)))
    return out


# ---------------------------------------------------------------------------
# operation counts (for the bound of chip_smoke.py)
# ---------------------------------------------------------------------------


def row_counts(low: Lowered) -> Dict[str, int]:
    """Goldilocks operations and words of one position of the lowered
    program, the uniform part left out (it runs once a block): "mul",
    "add", "sub" (a negation is a sub), as `goldilocks.cuh` spends them
    (an F_p^3 multiply 9 multiplies, 6 adds, 2 subs; a mixed multiply 3
    multiplies; a mixed add or sub touches the base coefficient only, and
    base - extension negates the other two); "read": distinct column and
    zerofier words loaded (a column at the row and at the next row is one
    column of the codeword, read once from memory), "written": output
    words."""
    out = dict.fromkeys(("mul", "add", "sub"), 0)

    def ext_of(v):
        return v[2] if v[0] == "c" else low.nodes[v[1]][1]

    columns = set()
    for k, (op, ext, args) in enumerate(low.nodes):
        if low.uniform[k]:
            continue
        if op in ("base", "ext"):
            columns.add((op, args[0]))
        elif op == "neg":
            out["sub"] += 3 if ext else 1
        elif op == "pow":
            raise ValueError("a power of a column value is not costed")
        elif op in ("add", "sub"):
            ea, eb = ext_of(args[0]), ext_of(args[1])
            if ea and eb:
                out[op] += 3
            else:
                out[op] += 1
                if op == "sub" and eb and not ea:
                    out["sub"] += 2
        elif op == "mul":
            ea, eb = ext_of(args[0]), ext_of(args[1])
            if ea and eb:
                out["mul"] += 9
                out["add"] += 6
                out["sub"] += 2
            else:
                out["mul"] += 3 if ext else 1
    kinds = set()
    for v, kind in low.outputs:
        out["mul"] += 3 if ext_of(v) else 1
        kinds.add(kind)
    out["read"] = sum(3 if kind == "ext" else 1 for kind, _ in columns)
    out["read"] += len(kinds)
    out["written"] = 3 * len(low.outputs)
    return out


# ---------------------------------------------------------------------------
# emitting C++
# ---------------------------------------------------------------------------


def _struct_name(name: str) -> str:
    return "Quotients" + name.capitalize()


def _literal(value, ext: bool) -> str:
    if ext:
        return "Xf{" + ", ".join(f"0x{int(c):X}ULL" for c in _lift(value)) + "}"
    return f"0x{int(value):X}ULL"


class _Emitter:
    def __init__(self, low: Lowered):
        self.low = low
        self.slots: Dict[int, int] = {}  # uniform node -> u[] slot

    def ext(self, v) -> bool:
        return v[2] if v[0] == "c" else self.low.nodes[v[1]][1]

    def ref(self, v, in_row: bool) -> str:
        if v[0] == "c":
            return _literal(v[1], v[2])
        k = v[1]
        if in_row and self.low.uniform[k]:
            if k not in self.slots:
                self.slots[k] = len(self.slots)
            return f"u[{self.slots[k]}]" + ("" if self.ext(v) else ".c0")
        return f"v{k}"

    def expr(self, k: int, in_row: bool) -> str:
        op, ext, args = self.low.nodes[k]
        if op == "base":
            return f"r.base({args[0]}, {args[1]})"
        if op == "ext":  # the launcher's columns: base ones first
            return (f"r.ext({self.low.program.base_width + args[0]}, "
                    f"{args[1]})")
        if op in ("ch", "tm"):
            src = "ch" if op == "ch" else "tm"
            i = 3 * args[0]
            return f"Xf{{{src}[{i}], {src}[{i + 1}], {src}[{i + 2}]}}"
        if op == "pow":
            exponent = (f"r.param({args[1]})" if in_row
                        else f"params[{args[1]}]")
            fn = "xf_pow" if ext else "gl_pow"
            return f"{fn}({self.ref(args[0], in_row)}, {exponent})"
        if op == "neg":
            return ("xf_neg" if ext else "gl_neg") + (
                f"({self.ref(args[0], in_row)})")
        a, b = args
        ra, rb = self.ref(a, in_row), self.ref(b, in_row)
        ea, eb = self.ext(a), self.ext(b)
        if op == "mul":
            if ea and eb:
                return f"xf_mul({ra}, {rb})"
            if ea or eb:
                return (f"xf_mul_base({ra}, {rb})" if ea
                        else f"xf_mul_base({rb}, {ra})")
            return f"gl_mul({ra}, {rb})"
        if not ext:
            return f"gl_{op}({ra}, {rb})"
        if ea and eb:
            return f"xf_{op}({ra}, {rb})"
        if op == "add":
            return (f"xf_add_base({ra}, {rb})" if ea
                    else f"xf_add_base({rb}, {ra})")
        return f"xf_sub_base({ra}, {rb})" if ea else f"xf_base_sub({ra}, {rb})"

    def store(self, t: int, v, kind: str) -> str:
        z = f"r.zinv({ZEROFIERS.index(kind)})"
        x = self.ref(v, True)
        if self.ext(v):
            return f"    r.store({t}, xf_mul_base({x}, {z}));"
        return f"    r.store({t}, Xf{{gl_mul({x}, {z}), 0, 0}});"

    def row(self) -> List[str]:
        """The row body: each non-uniform node, a load at its first use,
        each output stored right after the node it needs."""
        low = self.low
        lines: List[str] = []
        done = set()
        stores: Dict[int, List[int]] = {}
        for t, (v, _) in enumerate(low.outputs):
            if v[0] == "c" or low.uniform[v[1]]:
                lines.append(self.store(t, v, low.outputs[t][1]))
            else:
                stores.setdefault(v[1], []).append(t)

        def define(k):
            op, ext, _ = low.nodes[k]
            ctype = "Xf" if ext else "uint64_t"
            lines.append(f"    const {ctype} v{k} = {self.expr(k, True)};")
            done.add(k)

        for k, (op, _, args) in enumerate(low.nodes):
            if low.uniform[k] or op in ("base", "ext"):
                continue
            operands = args[:1] if op == "pow" else args
            for a in operands:
                if (a[0] == "n" and a[1] not in done
                        and not low.uniform[a[1]]):
                    define(a[1])  # a load, at its first use
            define(k)
            for t in stores.get(k, ()):
                lines.append(self.store(t, ("n", k), low.outputs[t][1]))
        for k, ts in stores.items():  # outputs that are loads themselves
            if low.nodes[k][0] in ("base", "ext"):
                if k not in done:
                    define(k)
                lines += [self.store(t, ("n", k), low.outputs[t][1])
                          for t in ts]
        return lines

    def uniform(self) -> List[str]:
        """The uniform body: every uniform node the row reads, into u[]."""
        low = self.low
        need = set(self.slots)
        # operands come before their users: one pass from the last node
        for k in range(len(low.nodes) - 1, -1, -1):
            op, _, args = low.nodes[k]
            if k in need and op in ("add", "sub", "mul", "neg", "pow"):
                operands = args[:1] if op == "pow" else args
                need |= {a[1] for a in operands if a[0] == "n"}
        lines = []
        for k in sorted(need):
            ext = low.nodes[k][1]
            ctype = "Xf" if ext else "uint64_t"
            lines.append(f"    const {ctype} v{k} = {self.expr(k, False)};")
        for k, slot in sorted(self.slots.items(), key=lambda kv: kv[1]):
            value = f"v{k}" if low.nodes[k][1] else f"Xf{{v{k}, 0, 0}}"
            lines.append(f"    u[{slot}] = {value};")
        return lines


def emit_table(name: str, prog: Program) -> str:
    """One table's struct: its key and sizes, `uniform` (the values that
    depend on no column, into u[]) and `row` (one position)."""
    low = lower(prog)
    em = _Emitter(low)
    row = em.row()  # assigns the u[] slots the row reads
    uniform = em.uniform()
    counts = row_counts(low)
    return "\n".join([
        f"// {name}: {len(prog.ops)} recorded operations, {len(low.nodes)} "
        f"after lowering; {len(prog.outputs)} quotients;",
        f"// a position: {counts['mul']} multiplies, {counts['add']} adds, "
        f"{counts['sub']} subs, {counts['read']} words read, "
        f"{counts['written']} written",
        f"struct {_struct_name(name)} {{",
        f"  static constexpr uint64_t kKey = 0x{prog.key:016X}ULL;",
        f"  static constexpr int kBase = {prog.base_width}, "
        f"kExt = {prog.ext_width}, kOutputs = {len(prog.outputs)}, "
        f"kUniform = {len(em.slots)}, kParams = {len(prog.params)};",
        "",
        "  GL_FN static void uniform(const uint64_t* ch, const uint64_t* tm,",
        "                            const long long* params, Xf* u) {",
        "    (void)ch;",
        "    (void)tm;",
        "    (void)params;",
        *uniform,
        "  }",
        "",
        "  template <class R>",
        "  GL_FN static void row(const R& r, const Xf* u) {",
        "    (void)u;",
        *row,
        "  }",
        "};",
    ])


def emit(tables=None) -> str:
    """csrc/quotients_gen.cuh for the five tables (`template_tables`)."""
    tables = template_tables() if tables is None else tables
    names = [t.name for t in tables]
    if tuple(names) != TABLES:
        raise ValueError(f"tables {names}, not {TABLES}")
    parts = [
        "// Generated from the models by",
        f"//   {EMIT_COMMAND}",
        "// (ops/quotient_kernels.py): each table's Table.quotients as",
        "// straight-line code for kernel F4 (quotients.cu) and its host",
        "// harness. Do not edit; emit again after a change to the",
        "// constraints.",
        "",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        '#include "goldilocks.cuh"',
        "",
        "namespace {",
    ]
    for name, t in zip(names, tables):
        parts += ["", emit_table(name, program(t))]
    parts += [
        "",
        "}  // namespace",
        "",
        "// X(index, struct) for each table, in the prover's order",
        "#define QUOTIENT_TABLES(X) "
        + " ".join(f"X({i}, {_struct_name(n)})" for i, n in enumerate(names)),
        "",
    ]
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------


def _signature(fn, stream: bool):
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_longlong),
         ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_void_p] * 2
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
           ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        + ([ctypes.c_void_p] if stream else []))
    fn.restype = ctypes.c_int


def _kernel_lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("quotients")
        _signature(lib.quotients_launch, True)
        _LIB = lib
    return _LIB


def _host_lib():
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = cuda_build.load_host("quotients_host")
        _signature(lib.quotients_host, False)
        _HOST_LIB = lib
    return _HOST_LIB


def _check(rc: int, name: str):
    if rc == BAD_KEY:
        raise RuntimeError(
            f"{name}: the library's program differs from the models' (a "
            f"stale csrc/quotients_gen.cuh): run `{EMIT_COMMAND}`")
    if rc in (BAD_TABLE, BAD_SHAPE):
        raise RuntimeError(f"{name}: arguments the program does not take "
                           f"(code {rc})")
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError {rc}")


def _columns(base_cw, ext_cw, base_next, ext_next) -> List[int]:
    """F4's flat column arguments: (address, position stride, coefficient
    stride) of every base then extension column at the row, then the same
    at the next row, in words."""
    out: List[int] = []
    for base, ext in ((base_cw, ext_cw), (base_next, ext_next)):
        st = base.stride()
        for c in range(base.shape[0]):
            out += [base.data_ptr() + 8 * c * st[0], st[1], 0]
        st = ext.stride()
        for c in range(ext.shape[0]):
            out += [ext.data_ptr() + 8 * c * st[0], st[1], st[2]]
    return out


def _arguments(table: int, prog: Program, base_cw, ext_cw, challenges,
               terminals, zinv, rot, base_next, ext_next):
    """(the launcher's arguments after `table` and before the stream, the
    output) for operands on one device, checked against the program."""
    if not 0 <= table < len(TABLES):
        raise ValueError(f"no table {table}")
    n = int(base_cw.shape[1])
    shapes = [tuple(base_cw.shape), tuple(ext_cw.shape)]
    want = [(prog.base_width, n), (prog.ext_width, n, 3)]
    if base_next is None:
        base_next, ext_next = base_cw, ext_cw
    elif rot:
        raise ValueError("rolled next columns come with rot = 0")
    shapes += [tuple(base_next.shape), tuple(ext_next.shape)]
    want += want
    if shapes != want:
        raise ValueError(f"quotient columns {shapes}, want {want}")
    if not 0 <= rot < max(n, 1):
        raise ValueError(f"rot {rot} for n = {n}")
    if tuple(challenges.shape) != (11, 3) or tuple(terminals.shape) != (5, 3):
        raise ValueError(f"challenges {tuple(challenges.shape)}, terminals "
                         f"{tuple(terminals.shape)}")
    zs = []
    for kind in ZEROFIERS:
        z = zinv[kind]
        if z.dim() == 0:
            zs += [z.data_ptr(), 0]
        elif tuple(z.shape) == (n,):
            zs += [z.data_ptr(), z.stride(0)]
        else:
            raise ValueError(f"{kind} zerofier inverse {tuple(z.shape)} "
                             f"for n = {n}")
    cols = _columns(base_cw, ext_cw, base_next, ext_next)
    out = base_cw.new_empty((len(prog.outputs), n, 3))
    ncols = prog.base_width + prog.ext_width
    args = (prog.key, (ctypes.c_longlong * len(cols))(*cols), ncols,
            (ctypes.c_longlong * 6)(*zs), ctypes.c_void_p(challenges.data_ptr()),
            ctypes.c_void_p(terminals.data_ptr()),
            (ctypes.c_longlong * max(len(prog.params), 1))(*prog.params),
            len(prog.params), n, rot, ctypes.c_void_p(out.data_ptr()))
    return args, out


def quotient_stack(table: int, prog: Program, base_cw, ext_cw, challenges,
                   terminals, zinv: Dict[str, torch.Tensor], rot: int,
                   base_next=None, ext_next=None):
    """F4: `Table.quotients` of table `table` (its index in TABLES) as the
    (T, n, 3) int64 stack, one launch. base_cw (width, n), ext_cw (n_ext,
    n, 3): the columns at any strides (0 included), read where they lie;
    the next row is column position (i + rot) mod n, or, where base_next
    and ext_next are given (rot 0), those columns at i. challenges (11,
    3), terminals (5, 3); zinv {kind: (n,) or 0-dim}. `prog` is the
    table's recorded program (`program(table)`), whose key the library
    must hold and whose exponents it takes. All on one CUDA device (a 0-dim
    CPU constant is moved); a failed launch raises."""
    global LAUNCHES_QUOTIENT
    operands = [base_cw, ext_cw, challenges, terminals,
                *(zinv[k] for k in ZEROFIERS)]
    if base_next is not None:
        operands += [base_next, ext_next]
    device = card_device(*operands)
    if device is None:
        raise ValueError("quotient_stack launches on a CUDA device only")
    base_cw, ext_cw = _on(base_cw, device), _on(ext_cw, device)
    if base_next is not None:
        base_next, ext_next = _on(base_next, device), _on(ext_next, device)
    challenges = _on(challenges, device).contiguous()
    terminals = _on(terminals, device).contiguous()
    zinv = {k: _on(zinv[k], device) for k in ZEROFIERS}
    args, out = _arguments(table, prog, base_cw, ext_cw, challenges,
                           terminals, zinv, rot, base_next, ext_next)
    if out.numel() == 0:
        return out
    fn = _kernel_lib().quotients_launch
    with torch.cuda.device(device):
        rc = fn(table, *args, ctypes.c_void_p(_stream(device)))
    _check(rc, "quotients_launch")
    LAUNCHES_QUOTIENT += 1
    return out


def host_stack(table: int, prog: Program, base_cw, ext_cw, challenges,
               terminals, zinv: Dict[str, torch.Tensor], rot: int,
               base_next=None, ext_next=None):
    """`quotient_stack` on CPU tensors through the g++ build of the same
    generated body (`native/quotients_host.cpp`): the emitted C++ checked
    without a card. Not counted as a launch."""
    challenges, terminals = challenges.contiguous(), terminals.contiguous()
    args, out = _arguments(table, prog, base_cw, ext_cw, challenges,
                           terminals, zinv, rot, base_next, ext_next)
    _check(_host_lib().quotients_host(table, *args), "quotients_host")
    return out


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--emit", action="store_true", required=True,
                        help="write csrc/quotients_gen.cuh")
    parser.parse_args(argv)
    with open(GEN_PATH, "w") as fh:
        fh.write(emit())


if __name__ == "__main__":
    main()
