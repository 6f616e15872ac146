"""Kernel F4 (`csrc/quotients.cu`, `ops/quotient_kernels.py`): every
table's AIR quotients and the two permutation quotients, weighed into the
combination in one launch, from programs recorded from the models.

Field arithmetic is exact, so every comparison is equality of canonical
u64 words (tolerance 0). On the CPU:

  - each table's recorded program (`ProgramAlgebra`), run on the plain
    field operations (`interp.run_plain`), equals the port's op-by-op
    `_table_quotient_stack_plain` and the JAX package's
    `_table_quotient_stack(..., xp=np)` on seeded canonical columns: at the
    resident row shift, in a streamed class (shift unit_distance / B over
    S = N / B positions), with 0-dim zerofier inverses, on tables of
    height 0 and of height > 0, with the IO tables' exponent 0 and 1;
  - the plain fused function `_quotient_combination_plain` equals the JAX
    package's `_table_quotient_stack(..., xp=np)` then `_acc_group(...,
    xp=np)` for the five tables and the `comb_pa` stack, on seeded columns,
    weights, ratios and starts: resident, in a streamed class, and with
    the next row rolled across a mesh's ranks (one rank here);
  - the committed `csrc/quotients_gen.cuh` equals a fresh emit;
  - the generated C++ bodies, compiled with g++ (`native/quotients_host.cpp`,
    through `cuda_build.build_host`), equal the plain stack table by table
    in the same cases, on next-row columns rolled by the caller (rot 0) and
    on a zero-stride view of an empty table's columns; and the kernel's
    weighing (the same bodies, `WeighSink`, the lazy sums of
    `csrc/accumulate.cuh`) equals the plain fused function in the same
    cases, on edge weights, ratios and starts (0, 1, p - 1) and at a ragged
    n past one power-table tile;
  - the dispatch: CPU operands take the plain function and count no launch;
    operands that report a CUDA device reach the launcher once a
    combination (resident, streamed and mesh: the rolled columns as the
    next row, rot 0), through a stand-in that runs the host build of the
    same kernel, and a refused key or a failed launch raises; the resident
    prove evaluates the quotients once, a streamed prove once a class;
  - the program's operation counts equal the F1/F2 dispatches the op-by-op
    form makes (369 and 107 for the five tables of `+>[+<-]` and of
    `,+.`/`a`, 2 and 2 more with the permutation quotients).

The proofs' bytes against the JAX package's, which now run F4 on the card,
stay in tests/test_torch_stark.py (resident, streamed, mxu),
tests/test_torch_parallel.py (mesh); chip_smoke.py holds F4 to the plain
function on the card."""

import contextlib
import shutil

import numpy as np
import pytest
import torch

import stark_brainfuck_tpu as J
import stark_brainfuck_tpu_torch as TP
from stark_brainfuck_tpu.ops import xfield as jxf
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
# the fused combination: the plain function against the JAX package, and the
# kernel's weighing under g++ against the plain function
# ---------------------------------------------------------------------------

# "rolled": the next row rolled across a mesh's ranks (plain) or by the
# caller (the kernel's rot 0); "edges": resident, every weight, ratio and
# start one of 0, 1 and p - 1
FORMS = ("resident", "streamed", "rolled", "edges")
EDGE_WORDS = np.array([0, 1, P - 1], dtype=np.uint64)


def _combination_inputs(stark, n, uds, seed, edges=False):
    """Seeded numpy operands of the quotient combination at n positions:
    {"tables": [(base, ext, zinv)] in table order, "ch", "tm", "w",
    "ratios", "starts", "slots", "acc", "uds"}, the shifts drawn with
    repeats, as the prover's (`quotient_kernels.distinct_shifts`)."""
    tables = []
    for ti, t in enumerate(stark.tables):
        z = {k: _field((n,), seed + 10 * ti + i) for i, k in enumerate(KINDS)}
        if t.height == 0:
            z["transition"] = np.zeros((n,), dtype=np.uint64)
        tables.append((_field((t.base_width, n), seed + 10 * ti + 3),
                       _field((t.num_ext_columns, n, 3), seed + 10 * ti + 4),
                       z))
    T_ = qk.terms([qk.program(t) for t in stark.tables])
    shifts = np.random.default_rng(seed).integers(0, 9, T_).tolist()
    slots, distinct = qk.distinct_shifts(shifts)
    D = len(distinct)
    if edges:
        def words(shape, k):
            return np.resize(np.roll(EDGE_WORDS, k), shape).astype(np.uint64)
    else:
        def words(shape, k):
            return _field(shape, seed + 60 + k)
    return {"tables": tables, "ch": _field((11, 3), seed + 50),
            "tm": _field((5, 3), seed + 51), "w": words((T_, 2, 3), 0),
            "ratios": words((D,), 1), "starts": words((D,), 2),
            "slots": slots, "acc": _field((n, 3), seed + 55), "uds": uds}


def _form(stark, form, seed):
    """(inputs, uds) of a form: resident over the domain, or class-sized
    with each table's row shift unit_distance / CLASSES."""
    N = stark.fri.domain.length
    if form == "streamed":
        uds = [t.unit_distance(N) // CLASSES for t in stark.tables]
        return _combination_inputs(stark, N // CLASSES, uds, seed)
    return _combination_inputs(stark, N, None, seed, edges=form == "edges")


def _jax_combination(jb, x):
    """The JAX package's form: `_table_quotient_stack(xp=np)` then
    `_acc_group(xp=np)` for each table, then the comb_pa stack."""
    acc, n = x["acc"], x["acc"].shape[0]
    ratios, starts = x["ratios"][x["slots"]], x["starts"][x["slots"]]
    pos = 0
    for ti, (base, ext, zinv) in enumerate(x["tables"]):
        stack = np.asarray(jb._table_quotient_stack(
            ti, base, ext, x["ch"], x["tm"], tuple(zinv[k] for k in KINDS),
            np, ud=None if x["uds"] is None else x["uds"][ti]))
        sl = slice(pos, pos + stack.shape[0])
        acc = jb._acc_group(acc, stack, x["w"][sl], ratios[sl], starts[sl],
                            np, length=n)
        pos = sl.stop
    (_, e0, z), (_, e1, _), (_, e2, _) = x["tables"][:3]
    pa = np.stack([
        jxf.mul_base(jxf.sub(e0[0], e1[0], np), z["boundary"], np),
        jxf.mul_base(jxf.sub(e0[1], e2[0], np), z["boundary"], np)])
    return np.asarray(jb._acc_group(acc, pa, x["w"][pos:], ratios[pos:],
                                    starts[pos:], np, length=n))


def _port_args(x, wrap=lambda t: t):
    """`_quotient_combination`'s arguments of numpy inputs, as tensors
    passed through `wrap`."""
    def tw(a):
        return wrap(T(a.reshape(-1)).reshape(a.shape))

    tables = x["tables"]
    return (tw(x["acc"]), [tw(b) for b, _, _ in tables],
            [tw(e) for _, e, _ in tables], tw(x["ch"]), tw(x["tm"]),
            [{k: tw(v) for k, v in z.items()} for _, _, z in tables],
            tw(x["w"]), tw(x["ratios"]), tw(x["starts"]), x["slots"],
            x["uds"])


def _with_mesh(tb, mesh):
    """tb's tables and domain on a stark whose mesh is `mesh`."""
    stark = TP.BrainfuckStark.__new__(TP.BrainfuckStark)
    stark.__dict__.update(tables=tb.tables, fri=tb.fri, device=tb.device,
                          mesh=mesh)
    return stark


FUSED_CASES = [(key, form) for key in PROGRAMS for form in FORMS]


@pytest.mark.parametrize("key,form", FUSED_CASES,
                         ids=[f"{k}-{f}" for k, f in FUSED_CASES])
def test_plain_combination_equals_the_jax_stages(key, form):
    tb, jb = _starks(key)
    x = _form(tb, form, 300)
    want = _jax_combination(jb, x)
    stark = _with_mesh(tb, _OneRankMesh(wrap=lambda t: t)
                       if form == "rolled" else None)
    before = (qk.LAUNCHES_QUOTIENT, qk.LAUNCHES_QUOTIENT_PROLOGUE)
    # CPU operands: the public name is the plain function, no launch
    got = stark._quotient_combination(*_port_args(x))
    assert np.array_equal(U(got), want)
    assert (qk.LAUNCHES_QUOTIENT, qk.LAUNCHES_QUOTIENT_PROLOGUE) == before
    if form == "rolled":
        assert stark.mesh.rolls == 2 * sum(
            1 for t in tb.tables if t.unit_distance(tb.fri.domain.length))


def _host_tables(stark, x, form):
    """`quotient_combination`'s per-table operands of numpy inputs: the
    row shift as rot, or (form "rolled") the next row as rolled columns
    with rot 0."""
    N = stark.fri.domain.length
    n = x["acc"].shape[0]
    out = []
    for ti, (base, ext, z) in enumerate(x["tables"]):
        t = stark.tables[ti]
        ud = t.unit_distance(N) if x["uds"] is None else x["uds"][ti]
        b, e = T(base), T(ext.reshape(-1)).reshape(ext.shape)
        zt = {k: T(v) for k, v in z.items()}
        if form == "rolled":
            out.append((b, e, zt, 0, torch.roll(b, -ud, 1),
                        torch.roll(e, -ud, 1)))
        else:
            out.append((b, e, zt, ud % n))
    return out


def _host_combination(stark, x, form):
    progs = [qk.program(t) for t in stark.tables]
    acc = T(x["acc"].reshape(-1)).reshape(x["acc"].shape)
    return qk.host_combination(
        acc, progs, _host_tables(stark, x, form), T(x["ch"]), T(x["tm"]),
        T(x["w"].reshape(-1)).reshape(x["w"].shape), T(x["ratios"]),
        T(x["starts"]), x["slots"])


@needs_gxx
@pytest.mark.parametrize("key,form", FUSED_CASES,
                         ids=[f"{k}-{f}" for k, f in FUSED_CASES])
def test_kernel_weighing_under_gxx_equals_the_plain_combination(key, form):
    tb, _ = _starks(key)
    x = _form(tb, form, 400)
    want = tb._quotient_combination_plain(*_port_args(x))
    assert torch.equal(_host_combination(tb, x, form), want)


@needs_gxx
def test_kernel_weighing_under_gxx_at_a_ragged_n_past_one_tile():
    """n = 2^14 + 37 positions: the power tables' top part (h >= 1), a last
    block of 37 of 128 positions, row shifts taken mod n."""
    tb, _ = _starks("io")
    n = (1 << 14) + 37
    N = tb.fri.domain.length
    uds = [t.unit_distance(N) % n for t in tb.tables]
    x = _combination_inputs(tb, n, uds, 500)
    want = tb._quotient_combination_plain(*_port_args(x))
    assert torch.equal(_host_combination(tb, x, "streamed"), want)


@needs_gxx
def test_a_stale_program_key_is_refused_by_the_combination():
    tb, _ = _starks("io")
    x = _form(tb, "resident", 7)
    progs = [qk.program(t) for t in tb.tables]
    progs[4].ops.append(("const", 0))  # another structure, another key
    with pytest.raises(RuntimeError, match="stale csrc/quotients_gen.cuh"):
        qk.host_combination(
            T(x["acc"].reshape(-1)).reshape(x["acc"].shape), progs,
            _host_tables(tb, x, "resident"), T(x["ch"]), T(x["tm"]),
            T(x["w"].reshape(-1)).reshape(x["w"].shape), T(x["ratios"]),
            T(x["starts"]), x["slots"])


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
    same kernel: records each launch's arguments, then runs it on the host
    (or returns `rc`)."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def quotients_uniform_words(self):
        return 0

    def quotients_launch(self, *args):
        self.calls.append(args)
        if self.rc:
            return self.rc
        # the scratch (tables, uniform values) and the stream are the
        # kernel's; the host harness makes its own
        return qk._host_lib().quotients_acc_host(*args[:16], args[18])


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
    """`parallel/mesh.py`'s roll on one rank: the whole codeword, passed
    through `wrap` (a CUDA-reporting tensor by default)."""

    def __init__(self, wrap=None):
        self.rolls = 0
        self.wrap = wrap or _cuda

    def roll(self, arr, shift, axis, n):
        self.rolls += 1
        return self.wrap(_ROLL(arr.as_subclass(torch.Tensor), -shift, axis))


_ROLL = torch.roll


@needs_gxx
@pytest.mark.parametrize("path", ["resident", "streamed", "mesh"])
def test_cuda_operands_take_one_f4_launch_a_table(stand_in, monkeypatch,
                                                  path):
    """CUDA operands take one F4 launch (after its prologue) for the five
    tables and the permutation quotients together: a resident combination,
    a streamed class, a mesh rank's block with the next row rolled across
    the ranks (rot 0). The launch gets the columns where they lie, each
    table's row shift, the distinct shifts' slots, and updates acc in place
    to the plain function's words."""
    tb, _ = _starks("io")
    stark = _with_mesh(tb, _OneRankMesh() if path == "mesh" else None)
    N = tb.fri.domain.length
    x = _form(tb, "streamed" if path == "streamed" else "resident", 40)
    want = tb._quotient_combination_plain(*_port_args(x))
    progs = [stark._quotient_program(ti) for ti in range(5)]
    args = _port_args(x, _cuda)
    _forbid_op_by_op(monkeypatch)
    before = (qk.LAUNCHES_QUOTIENT, qk.LAUNCHES_QUOTIENT_PROLOGUE)
    got = stark._quotient_combination(*args)
    assert got.data_ptr() == args[0].data_ptr(), "acc is updated in place"
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    assert (qk.LAUNCHES_QUOTIENT, qk.LAUNCHES_QUOTIENT_PROLOGUE) == (
        before[0] + 1, before[1] + 1)
    (call,) = stand_in.calls
    keys, cols, ncols, _, params, nparams, rots, n = call[:8]
    slots, terms, shifts = call[13:16]
    n_ = x["acc"].shape[0]
    assert n == n_ and list(keys)[:5] == [p.key for p in progs]
    assert list(ncols)[:5] == [t.full_width for t in tb.tables]
    assert list(nparams)[:5] == [len(p.params) for p in progs]
    assert list(params)[:20] == [v for p in progs
                                 for v in p.params + [0] * (4 - len(p.params))]
    assert (terms, shifts) == (qk.terms(progs), len(set(x["slots"])))
    assert list(slots)[:terms] == x["slots"]
    flat, pos = list(cols), 0
    for ti, t in enumerate(tb.tables):
        width = t.full_width
        cur = flat[pos:pos + 3 * width]
        nxt = flat[pos + 3 * width:pos + 6 * width]
        pos += 6 * width
        shift = t.unit_distance(N) if x["uds"] is None else x["uds"][ti]
        assert cur[0] == args[1][ti].data_ptr(), t.name
        if path == "mesh" and shift:
            assert rots[ti] == 0, "the mesh's rolled columns are the next row"
            assert nxt[0] != cur[0]
        else:
            # the columns where they lie: no copy of the next row
            assert rots[ti] == shift % n_ and nxt == cur, t.name
    if path == "mesh":
        assert stark.mesh.rolls == 2 * sum(
            1 for t in tb.tables if t.unit_distance(N))


def test_a_failed_launch_raises_and_is_not_counted(stand_in):
    tb, _ = _starks("io")
    x = _form(tb, "resident", 3)
    progs = [qk.program(t) for t in tb.tables]
    before = (qk.LAUNCHES_QUOTIENT, qk.LAUNCHES_QUOTIENT_PROLOGUE)
    for rc, match in ((700, "cudaError 700"),  # cudaErrorIllegalAddress
                      (qk.BAD_KEY, "stale csrc/quotients_gen.cuh"),
                      (qk.BAD_SHAPE, "does not take")):
        stand_in.rc = rc
        acc, bases, exts, ch, tm, zinvs, w, r, s, slots, _ = _port_args(
            x, _cuda)
        tables = [(b, e, z, t.unit_distance(tb.fri.domain.length))
                  for b, e, z, t in zip(bases, exts, zinvs, tb.tables)]
        with pytest.raises(RuntimeError, match=match):
            qk.quotient_combination(acc, progs, tables, ch, tm, w, r, s,
                                    slots)
    assert (qk.LAUNCHES_QUOTIENT, qk.LAUNCHES_QUOTIENT_PROLOGUE) == before


def test_quotient_stack_needs_a_cuda_device():
    """`quotient_combination` launches only; CPU operands go to the plain
    function through `_quotient_combination`, never here."""
    tb, _ = _starks("io")
    x = _form(tb, "resident", 3)
    acc, bases, exts, ch, tm, zinvs, w, r, s, slots, _ = _port_args(x)
    tables = [(b, e, z, 0) for b, e, z in zip(bases, exts, zinvs)]
    with pytest.raises(ValueError, match="CUDA device only"):
        qk.quotient_combination(acc, [qk.program(t) for t in tb.tables],
                                tables, ch, tm, w, r, s, slots)


def test_arguments_the_kernel_does_not_take_raise():
    tb, _ = _starks("io")
    x = _form(tb, "resident", 3)
    progs = [qk.program(t) for t in tb.tables]
    acc, bases, exts, ch, tm, zinvs, w, r, s, slots, _ = _port_args(x, _cuda)
    tables = [(b, e, z, 0) for b, e, z in zip(bases, exts, zinvs)]
    bad = {"slots": [len(set(slots))] + slots[1:], "w_pairs": w[1:],
           "tables": tables[:4], "acc": acc[1:]}
    for name, value in bad.items():
        kw = dict(acc=acc, progs=progs, tables=tables, challenges=ch,
                  terminals=tm, w_pairs=w, ratios=r, starts=s, slots=slots)
        kw[name] = value
        with pytest.raises(ValueError):
            qk.quotient_combination(**kw)


@pytest.mark.parametrize("classes", [None, 4])
def test_a_prove_evaluates_the_quotients_once_a_combination(monkeypatch,
                                                            classes):
    """The resident prove calls `_quotient_combination` once, over the
    whole domain, after F3's base and extension groups; a streamed prove
    once a class, over S = N / B positions (and that is F4's one launch a
    combination on the card). Seeded bytes equal the resident prove's."""
    calls, groups = [], []
    combine = TP.BrainfuckStark._quotient_combination
    acc_group = TP.BrainfuckStark._acc_group

    def record(self, acc, *args):
        calls.append((int(acc.shape[0]), len(groups)))
        return combine(self, acc, *args)

    def record_group(self, acc, stack, *args, **kw):
        groups.append(int(acc.shape[0]))
        return acc_group(self, acc, stack, *args, **kw)

    monkeypatch.setattr(TP.BrainfuckStark, "_quotient_combination", record)
    monkeypatch.setattr(TP.BrainfuckStark, "_acc_group", record_group)
    program = J.VirtualMachine.compile("++++")
    tr = J.VirtualMachine.simulate(program, "")
    config = ({} if classes is None
              else {"stream_min": 1, "stream_classes": classes})
    stark = TP.BrainfuckStark(
        tr["processor"].shape[0], tr["memory"].shape[0], program, "",
        tr["output_data"], TP.StarkConfig(seed=0, **config), device="cpu")
    proof = stark.prove(tr["processor"], tr["memory"], tr["instruction"],
                        tr["input"], tr["output"])
    N = stark.fri.domain.length
    B = classes or 1
    assert calls == [(N // B, 2 * (b + 1)) for b in range(B)]
    assert groups == [N // B] * (2 * B)
    if classes:
        resident = TP.BrainfuckStark(
            tr["processor"].shape[0], tr["memory"].shape[0], program, "",
            tr["output_data"], TP.StarkConfig(seed=0), device="cpu")
        assert proof == resident.prove(tr["processor"], tr["memory"],
                                       tr["instruction"], tr["input"],
                                       tr["output"])


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
    summed = dict.fromkeys(("add", "sub", "mul", "xmul", "xmul_base", "neg",
                            "from_base"), 0)
    before = qk.LAUNCHES_QUOTIENT
    for ti, t in enumerate(tb.tables):
        base, ext, ch, tm, zinv, ud = _torch(_inputs(tb, ti, "resident", ti))
        seen = _count_dispatches(
            monkeypatch, lambda: tb._table_quotient_stack_plain(
                ti, base, ext, ch, tm, zinv, ud))
        want = interp.dispatches(qk.program(t))
        assert seen == want, t.name
        summed = {k: summed[k] + want[k] for k in summed}
        total["f1"] += want["add"] + want["sub"] + want["mul"]
        total["f2"] += want["xmul"] + want["xmul_base"]
    assert total == {"f1": 369, "f2": 107}
    # the whole op-by-op combination: the stacks, and the permutation
    # quotients' two subs (F1) and two mul_base (F2); its weighing is plain
    # torch
    args = _port_args(_form(tb, "resident", 9))
    seen = _count_dispatches(
        monkeypatch, lambda: tb._quotient_combination_plain(*args))
    assert seen == {**summed, "sub": summed["sub"] + 2,
                    "xmul_base": summed["xmul_base"] + 2}
    assert qk.LAUNCHES_QUOTIENT == before, "the CPU launches no F4"
