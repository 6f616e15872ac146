"""Kernel F4 (`csrc/quotients.cu`, `ops/quotient_kernels.py`): each table's
AIR quotients in one launch, from a program recorded from the models.

Field arithmetic is exact, so every comparison is equality of canonical
u64 words (tolerance 0). On the CPU:

  - each table's recorded program (`ProgramAlgebra`), run on the plain
    field operations (`interp.run_plain`), equals the port's op-by-op
    `_table_quotient_stack_plain` and the JAX package's
    `_table_quotient_stack(..., xp=np)` on seeded canonical columns: at the
    resident row shift, in a streamed class (shift unit_distance / B over
    S = N / B positions), with 0-dim zerofier inverses, on tables of
    height 0 and of height > 0, with the IO tables' exponent 0 and 1;
  - the committed `csrc/quotients_gen.cuh` equals a fresh emit;
  - the generated C++ body, compiled with g++ (`native/quotients_host.cpp`,
    through `cuda_build.build_host`), equals the plain stack in the same
    cases, on next-row columns rolled by the caller (rot 0) and on a
    zero-stride view of an empty table's columns;
  - the dispatch: CPU operands take the plain stack and count no launch;
    operands that report a CUDA device reach the launcher once a table
    (resident, streamed and mesh: the rolled columns as the next row, rot
    0), through a stand-in that runs the host build of the same body, and
    a refused key or a failed launch raises;
  - the program's operation counts equal the F1/F2 dispatches the op-by-op
    stack makes (369 and 107 for the five tables of `+>[+<-]` and of
    `,+.`/`a`).

The proofs' bytes against the JAX package's, which now run F4 on the card,
stay in tests/test_torch_stark.py (resident, streamed, mxu),
tests/test_torch_parallel.py (mesh); chip_smoke.py holds F4 to the plain
stack on the card."""

import contextlib
import shutil

import numpy as np
import pytest
import torch

import stark_brainfuck_tpu as J
import stark_brainfuck_tpu_torch as TP
from stark_brainfuck_tpu_torch.convert import tensor_to_u64 as U
from stark_brainfuck_tpu_torch.convert import u64_to_tensor as T
from stark_brainfuck_tpu_torch.models import interp
from stark_brainfuck_tpu_torch.ops import field as tf
from stark_brainfuck_tpu_torch.ops import quotient_kernels as qk
from stark_brainfuck_tpu_torch.ops import xfield as txf

torch.set_num_threads(1)

P = 2**64 - 2**32 + 1
KINDS = ("boundary", "transition", "terminal")
# "+>[+<-]" leaves the input and output tables empty (height 0); ",,,.."
# fills them, the input table 3 of 4 rows (exponent height - length = 1)
PROGRAMS = {"empty_io": ("+>[+<-]", ""), "io": (",,,..", "abc")}
CASES = ("resident", "streamed", "zero_dim_zinv")
CLASSES = 4
_STARKS = {}


def _starks(key):
    """(port stark on the CPU, JAX stark) of a program; no prove runs, the
    tables keep their constructed heights."""
    if key not in _STARKS:
        src, inp = PROGRAMS[key]
        program = J.VirtualMachine.compile(src)
        tr = J.VirtualMachine.simulate(program, inp)
        args = (tr["processor"].shape[0], tr["memory"].shape[0], program,
                inp, tr["output_data"])
        _STARKS[key] = (
            TP.BrainfuckStark(*args, TP.StarkConfig(seed=0), device="cpu"),
            J.BrainfuckStark(*args, J.StarkConfig(seed=0)))
    return _STARKS[key]


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, size=shape, dtype=np.uint64).reshape(-1)
    edges = np.array([0, 1, P - 1, 2**32 - 1, 2**32], dtype=np.uint64)
    x[: min(x.size, edges.size)] = edges[: x.size]
    return x.reshape(shape)


def _inputs(stark, ti, case, seed):
    """Seeded numpy operands of one table: (base (w, n), ext (e, n, 3),
    challenges, terminals, {kind: zinv}, ud or None for the resident
    shift)."""
    t = stark.tables[ti]
    N = stark.fri.domain.length
    n, ud = N, None
    if case == "streamed":
        n, ud = N // CLASSES, t.unit_distance(N) // CLASSES
    zshape = () if case == "zero_dim_zinv" else (n,)
    zinv = {k: _field(zshape, seed + 4 + i) for i, k in enumerate(KINDS)}
    if t.height == 0:
        zinv["transition"] = np.zeros(zshape, dtype=np.uint64)
    return (_field((t.base_width, n), seed),
            _field((t.num_ext_columns, n, 3), seed + 1),
            _field((11, 3), seed + 2), _field((5, 3), seed + 3), zinv, ud)


def _torch(inputs):
    base, ext, ch, tm, zinv, ud = inputs
    return (T(base), T(ext), T(ch), T(tm),
            {k: T(v.reshape(-1)).reshape(v.shape) for k, v in zinv.items()},
            ud)


def _next(stark, ti, base, ext, ud):
    """The next-row columns as the op-by-op stack rolls them."""
    if ud is None:
        ud = stark.tables[ti].unit_distance(stark.fri.domain.length)
    return torch.roll(base, -ud, 1), torch.roll(ext, -ud, 1)


CASE_IDS = [(key, ti, case) for key in PROGRAMS for ti in range(5)
            for case in CASES]


def _id(c):
    return f"{c[0]}-{qk.TABLES[c[1]]}-{c[2]}"


@pytest.mark.parametrize("key,ti,case", CASE_IDS, ids=[_id(c) for c in CASE_IDS])
def test_program_equals_both_op_by_op_stacks(key, ti, case):
    tb, jb = _starks(key)
    inputs = _inputs(tb, ti, case, 10 * ti)
    base, ext, ch, tm, zinv, ud = _torch(inputs)
    prog = qk.program(tb.tables[ti])
    plain = tb._table_quotient_stack_plain(ti, base, ext, ch, tm, zinv, ud)
    got = interp.run_plain(prog, base, ext, *_next(tb, ti, base, ext, ud),
                           ch, tm, zinv)
    assert torch.equal(got, plain)
    nb, ne, nch, ntm, nz, _ = inputs
    want = jb._table_quotient_stack(
        ti, nb, ne, nch, ntm, tuple(nz[k] for k in KINDS), np, ud=ud)
    assert np.array_equal(U(got), np.asarray(want))
    # the port's public name on CPU operands is the plain stack
    assert torch.equal(
        tb._table_quotient_stack(ti, base, ext, ch, tm, zinv, ud), plain)


def test_programs_have_the_io_exponent_as_a_runtime_input():
    tb, _ = _starks("io")
    progs = [qk.program(t) for t in tb.tables]
    assert [p.params for p in progs] == [[], [], [], [1], [0]]
    # the structure, and so the key, does not depend on the exponent
    templates = [qk.program(t) for t in qk.template_tables()]
    assert [p.key for p in progs] == [p.key for p in templates]
    assert len({p.key for p in templates}) == 5


def test_committed_generated_body_equals_a_fresh_emit():
    with open(qk.GEN_PATH) as fh:
        committed = fh.read()
    assert committed == qk.emit(), f"stale: run `{qk.EMIT_COMMAND}`"


needs_gxx = pytest.mark.skipif(shutil.which(TP.ops.cuda_build.GXX) is None,
                               reason="needs g++ for the host build of F4's "
                                      "body")


@needs_gxx
@pytest.mark.parametrize("key,ti,case", CASE_IDS, ids=[_id(c) for c in CASE_IDS])
def test_generated_body_under_gxx_equals_the_plain_stack(key, ti, case):
    tb, _ = _starks(key)
    base, ext, ch, tm, zinv, ud = _torch(_inputs(tb, ti, case, 10 * ti + 1))
    want = tb._table_quotient_stack_plain(ti, base, ext, ch, tm, zinv, ud)
    prog = qk.program(tb.tables[ti])
    n = base.shape[1]
    shift = tb.tables[ti].unit_distance(tb.fri.domain.length) if ud is None \
        else ud
    got = qk.host_stack(ti, prog, base, ext, ch, tm, zinv, shift % n)
    assert torch.equal(got, want)
    # the next row given as columns the caller rolled, with rot 0
    rolled = qk.host_stack(ti, prog, base, ext, ch, tm, zinv, 0,
                           *_next(tb, ti, base, ext, ud))
    assert torch.equal(rolled, want)


@needs_gxx
def test_generated_body_reads_strided_and_zero_stride_columns():
    """The LDE's layouts: base columns as rows of a larger block, extension
    columns as a `movedim` view (coefficient stride n), and an empty
    table's columns as a zero-stride view of one zero word."""
    tb, _ = _starks("empty_io")
    N = tb.fri.domain.length
    for ti, t in enumerate(tb.tables):
        _, _, ch, tm, zinv, _ = _torch(_inputs(tb, ti, "resident", 70 + ti))
        if t.height:
            block = T(_field((3 + t.base_width, N), 80 + ti))
            base = block[3:]
            ext = T(_field((t.num_ext_columns, 3, N), 90 + ti)).movedim(1, -1)
        else:
            base = T(np.zeros((1,), np.uint64))[0].expand(t.base_width, N)
            ext = T(np.zeros((1,), np.uint64))[0].expand(
                t.num_ext_columns, N, 3)
        want = tb._table_quotient_stack_plain(ti, base.contiguous(),
                                              ext.contiguous(), ch, tm, zinv)
        got = qk.host_stack(ti, qk.program(t), base, ext, ch, tm, zinv,
                            t.unit_distance(N) % N)
        assert torch.equal(got, want), t.name


@needs_gxx
def test_a_stale_program_key_is_refused():
    tb, _ = _starks("io")
    base, ext, ch, tm, zinv, _ = _torch(_inputs(tb, 3, "resident", 5))
    prog = qk.program(tb.tables[3])
    prog.ops.append(("const", 0))  # another structure, another key
    with pytest.raises(RuntimeError, match="stale csrc/quotients_gen.cuh"):
        qk.host_stack(3, prog, base, ext, ch, tm, zinv, 0)


# ---------------------------------------------------------------------------
# dispatch, against a stand-in launcher
# ---------------------------------------------------------------------------


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that the wrappers take
    their kernel path against a stand-in launcher."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(x):
    return x.as_subclass(_ReportsCuda)


class _HostLaunch:
    """csrc/quotients.cu's library, stood in for by the g++ build of the
    same body: records each launch's arguments, then runs it on the host
    (or returns `rc`)."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def quotients_launch(self, table, *args):
        self.calls.append((table, args))
        if self.rc:
            return self.rc
        return qk._host_lib().quotients_host(table, *args[:-1])


@pytest.fixture
def stand_in(monkeypatch):
    lib = _HostLaunch()
    monkeypatch.setattr(qk, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(qk, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return lib


def _forbid_op_by_op(monkeypatch):
    """Every F1/F2 dispatch and every torch.roll from here on fails."""

    def never(*args, **kw):
        raise AssertionError("a CUDA operand went op by op")

    for mod, name in ((tf, "add"), (tf, "sub"), (tf, "mul"), (txf, "mul"),
                      (txf, "mul_base"), (torch, "roll")):
        monkeypatch.setattr(mod, name, never)


class _OneRankMesh:
    """`parallel/mesh.py`'s roll on one rank: the whole codeword."""

    def __init__(self):
        self.rolls = 0

    def roll(self, arr, shift, axis, n):
        self.rolls += 1
        return _cuda(_ROLL(arr.as_subclass(torch.Tensor), -shift, axis))


_ROLL = torch.roll


@needs_gxx
@pytest.mark.parametrize("path", ["resident", "streamed", "mesh"])
def test_cuda_operands_take_one_f4_launch_a_table(stand_in, monkeypatch,
                                                  path):
    tb, _ = _starks("io")
    stark = TP.BrainfuckStark.__new__(TP.BrainfuckStark)
    stark.__dict__.update(tables=tb.tables, fri=tb.fri, device=tb.device,
                          mesh=_OneRankMesh() if path == "mesh" else None)
    N = tb.fri.domain.length
    case = "streamed" if path == "streamed" else "resident"
    operands = [_torch(_inputs(tb, ti, case, 40 + ti)) for ti in range(5)]
    wants = [tb._table_quotient_stack_plain(ti, *ops)
             for ti, ops in enumerate(operands)]
    [qk.program(t) for t in tb.tables]  # recorded before the ops are barred
    _forbid_op_by_op(monkeypatch)
    before = qk.LAUNCHES_QUOTIENT
    for ti, t in enumerate(tb.tables):
        base, ext, ch, tm, zinv, ud = operands[ti]
        want = wants[ti]
        got = stark._table_quotient_stack(
            ti, _cuda(base), _cuda(ext), _cuda(ch), _cuda(tm),
            {k: _cuda(v) for k, v in zinv.items()}, ud)
        assert torch.equal(got.as_subclass(torch.Tensor), want), t.name
        table, args = stand_in.calls[-1]
        key, cols, ncols, _, _, _, params, nparams, n, rot = args[:10]
        assert (table, key, ncols, n) == (
            ti, qk.program(t).key, t.full_width, base.shape[1])
        assert list(params)[:nparams] == qk.program(t).params
        shift = t.unit_distance(N) if ud is None else ud
        if path == "mesh" and shift:
            assert rot == 0, "the mesh's rolled columns are the next row"
        else:
            assert rot == shift % n
            # the columns where they lie: no copy of the next row
            flat = list(cols)
            assert flat[:3 * ncols] == flat[3 * ncols:6 * ncols]
            assert flat[0] == base.data_ptr()
    assert qk.LAUNCHES_QUOTIENT == before + 5
    if path == "mesh":
        assert stark.mesh.rolls == 2 * sum(
            1 for t in tb.tables if t.unit_distance(N))


def test_a_failed_launch_raises_and_is_not_counted(stand_in):
    stand_in.rc = 700  # cudaErrorIllegalAddress
    tb, _ = _starks("io")
    base, ext, ch, tm, zinv, _ = _torch(_inputs(tb, 2, "resident", 3))
    before = qk.LAUNCHES_QUOTIENT
    with pytest.raises(RuntimeError, match="cudaError 700"):
        qk.quotient_stack(2, qk.program(tb.tables[2]), _cuda(base),
                          _cuda(ext), _cuda(ch), _cuda(tm),
                          {k: _cuda(v) for k, v in zinv.items()}, 1)
    assert qk.LAUNCHES_QUOTIENT == before


def test_quotient_stack_needs_a_cuda_device():
    tb, _ = _starks("io")
    base, ext, ch, tm, zinv, _ = _torch(_inputs(tb, 2, "resident", 3))
    with pytest.raises(ValueError, match="CUDA device only"):
        qk.quotient_stack(2, qk.program(tb.tables[2]), base, ext, ch, tm,
                          zinv, 1)


# ---------------------------------------------------------------------------
# launch bookkeeping
# ---------------------------------------------------------------------------


def _count_dispatches(monkeypatch, fn):
    """The F1 (add, sub, mul), F2 (xmul, xmul_base) and other (neg,
    from_base) field operations fn() dispatches through the public
    names."""
    counts = dict.fromkeys(("add", "sub", "mul", "xmul", "xmul_base", "neg",
                            "from_base"), 0)

    def counted(mod, name, key):
        inner = getattr(mod, name)

        def wrapper(*args):
            counts[key] += 1
            return inner(*args)

        monkeypatch.setattr(mod, name, wrapper)

    for mod, name, key in ((tf, "add", "add"), (tf, "sub", "sub"),
                           (tf, "mul", "mul"), (tf, "neg", "neg"),
                           (txf, "mul", "xmul"),
                           (txf, "mul_base", "xmul_base"),
                           (txf, "from_base", "from_base")):
        counted(mod, name, key)
    fn()
    monkeypatch.undo()
    return counts


@pytest.mark.parametrize("src,inp", [("+>[+<-]", ""), (",+.", "a")])
def test_program_counts_equal_the_dispatches_f4_replaces(monkeypatch, src,
                                                         inp):
    program = J.VirtualMachine.compile(src)
    tr = J.VirtualMachine.simulate(program, inp)
    tb = TP.BrainfuckStark(tr["processor"].shape[0], tr["memory"].shape[0],
                           program, inp, tr["output_data"],
                           TP.StarkConfig(seed=0), device="cpu")
    total = dict.fromkeys(("f1", "f2"), 0)
    before = qk.LAUNCHES_QUOTIENT
    for ti, t in enumerate(tb.tables):
        base, ext, ch, tm, zinv, ud = _torch(_inputs(tb, ti, "resident", ti))
        seen = _count_dispatches(monkeypatch, lambda: tb._table_quotient_stack(
            ti, base, ext, ch, tm, zinv, ud))
        want = interp.dispatches(qk.program(t))
        assert seen == want, t.name
        total["f1"] += want["add"] + want["sub"] + want["mul"]
        total["f2"] += want["xmul"] + want["xmul_base"]
    assert total == {"f1": 369, "f2": 107}
    assert qk.LAUNCHES_QUOTIENT == before, "the CPU launches no F4"
