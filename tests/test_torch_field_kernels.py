"""The field layer's kernels F1, F2, F3 (`csrc/field.cu`) and their plain
torch versions vs the JAX package, exact: field arithmetic has no rounding,
so every comparison is equality of the canonical u64 words (tolerance 0).

On the CPU the public names (`field.add/sub/mul`, `xfield.mul/mul_base`,
`BrainfuckStark._acc_group`) run their plain versions; these are held to
the JAX package's `xp=np` functions on broadcast shapes and strided views,
the shapes the prover gives them. The kernels cannot run here, so what
surrounds them is checked instead: the broadcast layout the wrappers pass
(`field_kernels._layout`) is replayed with the kernels' index arithmetic,
F3's square-and-multiply schedule is replayed position by position, and
the dispatch (CUDA tensors to the launcher and never to a plain body, a
failed launch raises, other devices raise) runs against a stand-in
launcher. The card-only test at the end and chip_smoke.py hold the kernels
to the plain versions."""

import contextlib
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stark_brainfuck_tpu.ops import field as jf
from stark_brainfuck_tpu.ops import xfield as jxf
from stark_brainfuck_tpu.protocol.stark import BrainfuckStark as JBrainfuckStark
from stark_brainfuck_tpu_torch.convert import tensor_to_u64 as U
from stark_brainfuck_tpu_torch.convert import u64_to_tensor as T
from stark_brainfuck_tpu_torch.ops import field as tf
from stark_brainfuck_tpu_torch.ops import field_kernels as fk
from stark_brainfuck_tpu_torch.ops import xfield as txf
from stark_brainfuck_tpu_torch.protocol.stark import BrainfuckStark

torch.set_num_threads(1)

P = jf.P
EDGES = np.array(
    [0, 1, P - 1, 2**32 - 1, 2**32, 2**32 + 1, 2**63 % P, P - 2],
    dtype=np.uint64,
)
CSRC = os.path.join(os.path.dirname(os.path.abspath(fk.__file__)), "..",
                    "csrc", "field.cu")


def _field(shape, seed):
    """Seeded canonical words of `shape`, the edge values at the front (in
    a different order for every seed, so edge meets edge)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, size=shape, dtype=np.uint64).reshape(-1)
    k = min(x.size, 4 * EDGES.size)
    x[:k] = np.tile(rng.permutation(EDGES), 4)[:k]
    return x.reshape(shape)


def _move(x):
    """Axis 1 to the end: `movedim(1, -1)` in torch, `moveaxis` in numpy."""
    if isinstance(x, np.ndarray):
        return np.moveaxis(x, 1, -1)
    return x.movedim(1, -1)


def _same(x):
    return x


# (name, base shape of a, view of a, base shape of b, view of b): the
# broadcast and strided forms of the prover's call sites
BASE_CASES = [
    ("0-dim constant", (40,), _same, (), _same),
    ("twiddle row [None, None, :]", (2, 3, 16), lambda x: x[:, :, 8:],
     (8,), lambda t: t[None, None, :]),
    ("(T, 1, 3) against (T, N, 3)", (4, 1, 3), _same, (4, 50, 3), _same),
    ("columns [..., k]", (50, 3), lambda x: x[..., 1], (50, 3),
     lambda x: x[..., 2]),
    ("movedim view", (2, 3, 50), _move, (2, 50, 3), _same),
    ("transposed", (16, 8), lambda x: x.T, (8, 16), _same),
    ("w_plain[:, None, :]", (5, 2, 3), lambda x: x[:, 0][:, None, :],
     (5, 20, 3), _same),
]

EXT_CASES = [
    ("one extension constant", (40, 3), _same, (3,), _same),
    ("(T, 1, 3) against (T, N, 3)", (4, 1, 3), _same, (4, 50, 3), _same),
    ("movedim view", (2, 3, 50), _move, (2, 50, 3), _same),
    ("[None] row", (1, 3), _same, (50, 3), _same),
    ("strided rows", (60, 3), lambda x: x[::2], (2, 30, 3),
     lambda x: x[1]),
]

# mul_base: extension a, base b
EXT_BASE_CASES = [
    ("0-dim base", (40, 3), _same, (), _same),
    ("(T, 1, 3) against (T, N)", (4, 1, 3), _same, (4, 50), _same),
    ("movedim view and a column", (2, 3, 50), _move, (2, 50, 3),
     lambda x: x[..., 0]),
    ("w_shift[:, None, :]", (5, 2, 3), lambda x: x[:, 1][:, None, :],
     (5, 20), _same),
]


def _pair(case, seed):
    """(a, b) as numpy views and as torch views of the same words."""
    _, sa, va, sb, vb = case
    a, b = _field(sa, seed), _field(sb, seed + 1)
    return (va(a), vb(b)), (va(T(a).reshape(sa)), vb(T(b).reshape(sb)))


def _ids(cases):
    return [c[0] for c in cases]


# ---------------------------------------------------------------------------
# the plain versions, as the public names reach them on the CPU, vs JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("case", BASE_CASES, ids=_ids(BASE_CASES))
def test_base_ops_match_jax_on_broadcast_and_strided_operands(case, op):
    (na, nb), (ta, tb) = _pair(case, 10)
    want = getattr(jf, op)(na, nb, np)
    got = getattr(tf, op)(ta, tb)
    assert got.shape == want.shape
    assert np.array_equal(U(got), want)


@pytest.mark.parametrize("case", EXT_CASES, ids=_ids(EXT_CASES))
def test_xfield_mul_matches_jax_on_broadcast_and_strided_operands(case):
    (na, nb), (ta, tb) = _pair(case, 20)
    for x, y, tx, ty in ((na, nb, ta, tb), (nb, na, tb, ta)):
        want = jxf.mul(x, y, np)
        got = txf.mul(tx, ty)
        assert got.shape == want.shape
        assert np.array_equal(U(got), want)


@pytest.mark.parametrize("case", EXT_BASE_CASES, ids=_ids(EXT_BASE_CASES))
def test_xfield_mul_base_matches_jax(case):
    (na, nb), (ta, tb) = _pair(case, 30)
    want = jxf.mul_base(na, nb, np)
    got = txf.mul_base(ta, tb)
    assert got.shape == want.shape
    assert np.array_equal(U(got), want)


def test_xfield_edge_values_match_jax():
    """Every pair of extension elements whose coefficients are edge
    values."""
    e = np.stack(np.meshgrid(EDGES, EDGES, EDGES), axis=-1).reshape(-1, 3)
    a = np.repeat(e, e.shape[0], axis=0)
    b = np.tile(e, (e.shape[0], 1))
    assert np.array_equal(U(txf.mul(T(a), T(b))), jxf.mul(a, b, np))
    base = np.tile(EDGES, a.shape[0] // EDGES.size)
    assert np.array_equal(U(txf.mul_base(T(a), T(base))),
                          jxf.mul_base(a, base, np))


# ---------------------------------------------------------------------------
# F1 and F2 as the kernels index: the wrapper's layout, replayed
# ---------------------------------------------------------------------------


def _offsets(sizes, strides, total):
    """csrc/field.cu `element_offsets` for every element at once."""
    e = torch.arange(total)
    off = [torch.zeros(total, dtype=torch.int64) for _ in strides]
    for d in range(len(sizes) - 1, 0, -1):
        i = e % sizes[d]
        e = e // sizes[d]
        for o, st in zip(off, strides):
            o += i * st[d]
    for o, st in zip(off, strides):
        o += e * st[0]
    return off


def _read(t, offsets):
    """Words of t's storage at the offsets from its first element."""
    flat = torch.as_strided(t, (int(offsets.max()) + 1,), (1,))
    return flat[offsets]


def _emulate_gl(fn, a, b):
    shape = torch.broadcast_shapes(a.shape, b.shape)
    sizes, strides = fk._layout(
        shape, [(a.shape, a.stride()), (b.shape, b.stride())])
    assert len(sizes) <= fk.MAX_DIMS
    total = int(np.prod(shape, dtype=np.int64))
    oa, ob = _offsets(sizes, strides, total)
    return fn(_read(a, oa), _read(b, ob)).reshape(shape)


def _emulate_xf(ext_b, a, b):
    be = (b.shape[:-1], b.stride()[:-1]) if ext_b else (b.shape, b.stride())
    shape = torch.broadcast_shapes(a.shape[:-1], be[0])
    sizes, strides = fk._layout(shape, [(a.shape[:-1], a.stride()[:-1]), be])
    total = int(np.prod(shape, dtype=np.int64))
    oa, ob = _offsets(sizes, strides, total)
    ca = a.stride(-1)
    x = torch.stack([_read(a, oa + k * ca) for k in range(3)], dim=-1)
    if ext_b:
        cb = b.stride(-1)
        y = torch.stack([_read(b, ob + k * cb) for k in range(3)], dim=-1)
        out = txf.mul_plain(x, y)
    else:
        out = txf.mul_base_plain(x, _read(b, ob))
    return out.reshape(tuple(shape) + (3,))


@pytest.mark.parametrize("case", BASE_CASES, ids=_ids(BASE_CASES))
def test_f1_layout_reads_every_operand_where_it_lies(case):
    _, (ta, tb) = _pair(case, 40)
    for fn in (tf.add_plain, tf.sub_plain, tf.mul_plain):
        assert torch.equal(_emulate_gl(fn, ta, tb), fn(ta, tb))


@pytest.mark.parametrize("case", EXT_CASES + EXT_BASE_CASES,
                         ids=_ids(EXT_CASES) + _ids(EXT_BASE_CASES))
def test_f2_layout_reads_every_coefficient_where_it_lies(case):
    _, (ta, tb) = _pair(case, 50)
    ext_b = tb.dim() > 0 and tb.shape[-1] == 3 and case in EXT_CASES
    want = txf.mul_plain(ta, tb) if ext_b else txf.mul_base_plain(ta, tb)
    assert torch.equal(_emulate_xf(ext_b, ta, tb), want)


def test_layout_merges_axes_and_drops_broadcast_ones():
    x = torch.zeros((27, 1024, 2048), dtype=torch.int64)
    contiguous = [(x.shape, x.stride())] * 2
    assert fk._layout(x.shape, contiguous) == ([27 * 1024 * 2048],
                                                [[1], [1]])
    odd = x[:, :, 1024:]
    tw = torch.zeros(1024, dtype=torch.int64)[None, None, :]
    sizes, strides = fk._layout(odd.shape, [(odd.shape, odd.stride()),
                                            (tw.shape, tw.stride())])
    assert sizes == [27 * 1024, 1024] and strides == [[2048, 1], [0, 1]]
    assert fk._layout((), [((), ()), ((), ())])[0] == [1]
    many = (2,) * (fk.MAX_DIMS + 1)
    t = torch.zeros(many, dtype=torch.int64)
    assert fk._layout(many, [(t.shape, t.stride()),
                             (t.shape, t.permute(*range(t.dim())[::-1]).stride())]) is None


# ---------------------------------------------------------------------------
# F3: `_acc_group_plain` vs the JAX `_acc_group(xp=np)`, and F3's schedule
# ---------------------------------------------------------------------------


def _stub(N):
    """A port stark with what `_acc_group` reads of it: the FRI domain
    length."""
    stark = BrainfuckStark.__new__(BrainfuckStark)
    stark.fri = SimpleNamespace(domain=SimpleNamespace(length=N))
    return stark


def _jax_stub(N):
    """The same for the JAX package's, which also calls `_shard` (the
    identity without a mesh)."""
    return SimpleNamespace(fri=SimpleNamespace(domain=SimpleNamespace(length=N)),
                           _shard=lambda arr, axis: arr)


def _group(T_, N, ext, seed):
    """Seeded acc, stack, w_pairs, ratios and starts of one group."""
    acc = _field((N, 3), seed)
    stack = _field((T_, N, 3) if ext else (T_, N), seed + 1)
    w_pairs = _field((T_, 2, 3), seed + 2)
    ratios = _field((T_,), seed + 3)
    starts = _field((T_,), seed + 4)
    return acc, stack, w_pairs, ratios, starts


@pytest.mark.parametrize("length", [None, 40])
@pytest.mark.parametrize("T_", [1, 16, 17])
@pytest.mark.parametrize("ext", [False, True], ids=["base", "ext"])
def test_acc_group_plain_matches_jax(ext, T_, length):
    N = 96
    n = length or N
    group = _group(T_, n, ext, 60 + T_)
    want = JBrainfuckStark._acc_group(_jax_stub(N), *group, np,
                                       length=length)
    got = _stub(N)._acc_group_plain(*(T(g) for g in group), length=length)
    assert np.array_equal(U(got), np.asarray(want))
    # on the CPU the public name is the plain version
    public = BrainfuckStark._acc_group(
        _stub(N), *(T(g) for g in group), length=length)
    assert torch.equal(public, got)


def _field_cu_const(name):
    with open(CSRC) as fh:
        return int(re.search(rf"{name} = (\d+);", fh.read()).group(1))


def _emulate_acc_group(acc, stack, w_pairs, ratios, starts, n):
    """csrc/field.cu `acc_group_kernel`, every thread of every block at
    once: thread j of block g owns positions g·2^(lt+lr) + j + k·2^lt, and
    raises ratio to its first one by its own bits, then the block's."""
    lt = _field_cu_const("kAccLogThreads")
    lr = _field_cu_const("kAccLogRun")
    threads, run = 1 << lt, 1 << lr
    blocks = -(-n // (threads * run))
    tid = torch.arange(threads)[None, :]
    blk = torch.arange(blocks)[:, None]
    p0 = (blk << (lt + lr)) + tid
    mul, add = tf.mul_plain, tf.add_plain
    s = torch.zeros((run, blocks, threads, 3), dtype=torch.int64)
    ext = stack.dim() == 3
    for t in range(stack.shape[0]):
        x = starts[t].expand(blocks, threads)
        b = ratios[t]
        for k in range(lt):
            x = torch.where((tid >> k) & 1 == 1, mul(x, b), x)
            b = mul(b, b)
        step = b
        for _ in range(lr):
            b = mul(b, b)
        e = blk.expand(blocks, threads)
        while bool((e > 0).any()):
            x = torch.where(e & 1 == 1, mul(x, b), x)
            b = mul(b, b)
            e = e >> 1
        for k in range(run):
            p = p0 + k * threads
            valid = p < n
            c = add(mul(w_pairs[t, 1], x[..., None]), w_pairs[t, 0])
            v = stack[t, p.clamp(max=n - 1)]
            r = txf.mul_plain(c, v) if ext else txf.mul_base_plain(c, v)
            s[k] = torch.where(valid[..., None], add(s[k], r), s[k])
            x = mul(x, step)
    out = acc.clone()
    for k in range(run):
        p = (p0 + k * threads).reshape(-1)
        keep = p < n
        out[p[keep]] = add(out[p[keep]], s[k].reshape(-1, 3)[keep])
    return out


@pytest.mark.parametrize("ext", [False, True], ids=["base", "ext"])
def test_acc_group_kernel_schedule_matches_plain(ext):
    """Three blocks, the last one ragged: every position's x^s comes from
    the right power, and each sum reaches acc once."""
    n = 2 * 1024 + 300
    group = [T(g) for g in _group(5, n, ext, 70)]
    if ext:
        # the streamed path's stack: a movedim view with strided coefficients
        group[1] = group[1].movedim(-1, 1).contiguous().movedim(1, -1)
    want = BrainfuckStark._acc_group_plain(_stub(n), *group)
    assert torch.equal(_emulate_acc_group(*group, n), want)


# ---------------------------------------------------------------------------
# dispatch: CUDA tensors reach the launcher, other devices raise
# ---------------------------------------------------------------------------


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that the wrappers take
    their kernel path against a stand-in launcher."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(x):
    return torch.Tensor._make_subclass(_ReportsCuda, T(x))


class _Lib:
    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name, args))
            return self.rc

        return launch


@pytest.fixture
def stand_in(monkeypatch):
    """A stand-in library of csrc/field.cu and plain bodies that fail if
    reached; returns the library."""
    lib = _Lib()
    monkeypatch.setattr(fk, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(fk, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())

    def never(*args, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((tf, "add_plain"), (tf, "sub_plain"),
                      (tf, "mul_plain"), (txf, "mul_plain"),
                      (txf, "mul_base_plain")):
        monkeypatch.setattr(mod, name, never)
    monkeypatch.setattr(BrainfuckStark, "_acc_group_plain", never)
    return lib


def test_cuda_tensors_reach_the_launchers_and_are_counted(stand_in):
    a, b = _cuda(_field((6, 3), 1)), _cuda(_field((6, 3), 2))
    base = _cuda(_field((6,), 3))
    before = (fk.LAUNCHES_ELEMENTWISE, fk.LAUNCHES_XFIELD, fk.LAUNCHES_ACC)
    for fn, op in ((tf.add, fk.ADD), (tf.sub, fk.SUB), (tf.mul, fk.MUL)):
        out = fn(a, b)
        assert out.shape == (6, 3) and out.is_contiguous()
        name, args = stand_in.calls[-1]
        assert name == "gl_binary_launch" and args[0] == op
        assert args[4] == 18 and args[5] == 1  # one merged axis of 18 words
    txf.add(a, b)
    assert stand_in.calls[-1][0] == "gl_binary_launch"
    for fn, op, y in ((txf.mul, fk.XMUL, b), (txf.mul_base, fk.XMUL_BASE,
                                                base)):
        assert fn(a, y).shape == (6, 3)
        name, args = stand_in.calls[-1]
        assert name == "xf_binary_launch" and args[0] == op and args[4] == 6
    acc = _cuda(_field((6, 3), 4))
    stack = _cuda(_field((2, 6, 3), 5))
    got = BrainfuckStark._acc_group(
        _stub(6), acc, stack, _cuda(_field((2, 2, 3), 6)),
        _cuda(_field((2,), 7)), _cuda(_field((2,), 8)))
    assert got is acc, "F3 updates a contiguous acc in place"
    name, args = stand_in.calls[-1]
    assert name == "acc_group_launch" and args[5:-1] == (2, 6, 18, 3, 1, 1)
    assert (fk.LAUNCHES_ELEMENTWISE, fk.LAUNCHES_XFIELD, fk.LAUNCHES_ACC) == (
        before[0] + 4, before[1] + 2, before[2] + 1)


def test_a_failed_launch_raises(stand_in):
    stand_in.rc = 700  # cudaErrorIllegalAddress
    a = _cuda(_field((4,), 1))
    before = fk.LAUNCHES_ELEMENTWISE
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tf.mul(a, a)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        txf.mul(_cuda(_field((4, 3), 2)), _cuda(_field((4, 3), 3)))
    assert fk.LAUNCHES_ELEMENTWISE == before, "a failed launch is not counted"


def test_other_devices_and_device_mixes_raise(stand_in):
    meta = torch.empty((4, 3), dtype=torch.int64, device="meta")
    for fn in (tf.add, tf.sub, tf.mul, txf.mul):
        with pytest.raises(ValueError, match="meta"):
            fn(meta, meta)
    with pytest.raises(ValueError, match="meta"):
        txf.mul_base(meta, meta[:, 0])
    with pytest.raises(ValueError, match="meta"):
        BrainfuckStark._acc_group(
            _stub(4), meta, meta[None], meta[:1, :2], meta[:1, 0],
            meta[:1, 0])
    cpu = T(_field((4,), 1))
    with pytest.raises(ValueError, match="CPU"):
        tf.mul(_cuda(_field((4,), 2)), cpu)
    with pytest.raises(ValueError, match="int64"):
        tf.add(_cuda(_field((4,), 2)), _cuda(_field((4,), 3)).int())
    assert not stand_in.calls


def test_cpu_tensors_count_no_launches():
    before = (fk.LAUNCHES_ELEMENTWISE, fk.LAUNCHES_XFIELD, fk.LAUNCHES_ACC)
    a = T(_field((8, 3), 1))
    tf.mul(a, a)
    txf.mul(a, a)
    txf.mul_base(a, a[:, 0])
    group = [T(g) for g in _group(2, 8, True, 3)]
    BrainfuckStark._acc_group(_stub(8), *group)
    assert (fk.LAUNCHES_ELEMENTWISE, fk.LAUNCHES_XFIELD,
            fk.LAUNCHES_ACC) == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: F1, F2 and F3 against their plain versions on the
    shapes above and at a full block of 2^21 words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels F1-F3 have no CPU mode)")

    def card(x):
        return x.to("cuda")

    for case in BASE_CASES:
        _, (ta, tb) = _pair(case, 80)
        for fn, plain in ((tf.add, tf.add_plain), (tf.sub, tf.sub_plain),
                          (tf.mul, tf.mul_plain)):
            ca = card(ta.contiguous()).as_strided(ta.shape, ta.stride())
            cb = card(tb.contiguous()).as_strided(tb.shape, tb.stride())
            assert torch.equal(fn(ca, cb).cpu(), plain(ta, tb))
    for cases, fn, plain in ((EXT_CASES, txf.mul, txf.mul_plain),
                             (EXT_BASE_CASES, txf.mul_base,
                              txf.mul_base_plain)):
        for case in cases:
            (na, nb), _ = _pair(case, 90)
            _, sa, va, sb, vb = case
            ca, cb = va(card(T(_field(sa, 90)))), vb(card(T(_field(sb, 91))))
            assert torch.equal(fn(ca, cb).cpu(), plain(ca, cb).cpu())
    big = card(T(_field((1 << 21,), 5)))
    assert torch.equal(tf.mul(big, big.flip(0)),
                       tf.mul_plain(big, big.flip(0)))
    for ext in (False, True):
        group = [card(T(g)) for g in _group(17, 5000, ext, 100)]
        want = BrainfuckStark._acc_group_plain(_stub(5000), *group)
        got = BrainfuckStark._acc_group(_stub(5000), group[0].clone(),
                                        *group[1:])
        assert torch.equal(got, want)
