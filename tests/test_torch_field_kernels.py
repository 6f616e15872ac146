"""The field layer's kernels F1, F2, F3 (`csrc/field.cu`) and their plain
torch versions vs the JAX package, exact: field arithmetic has no rounding,
so every comparison is equality of the canonical u64 words (tolerance 0).

On the CPU the public names (`field.add/sub/mul`, `xfield.mul/mul_base`,
`BrainfuckStark._acc_group`) run their plain versions; these are held to
the JAX package's `xp=np` functions on broadcast shapes and strided views,
the shapes the prover gives them. The kernels cannot run here, so what
surrounds them is checked instead: the broadcast layout the wrappers pass
(`field_kernels._layout`) is replayed with the kernels' index arithmetic;
F3's schedule is replayed block by block (its power tables, its launch
geometry and term split, its unreduced 160-bit sums and their meeting, its
columns read through the launcher's addresses and strides); the resident
prove is shown to hand F3 the LDE tensors' columns without a copy; and the
dispatch (CUDA tensors to the launcher and never to a plain body, a failed
launch raises, other devices raise) runs against a stand-in launcher. The
card-only test at the end and chip_smoke.py hold the kernels to the plain
versions."""

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
    """A constant of csrc/field.cu or of the header it shares with F4,
    csrc/accumulate.cuh (the power tables' split)."""
    text = ""
    for path in (CSRC, os.path.join(os.path.dirname(CSRC), "accumulate.cuh")):
        with open(path) as fh:
            text += fh.read()
    return int(re.search(rf"{name} = (\d+);", text).group(1))


M64 = 2**64 - 1
TILE, MID = fk.ACC_TILE, fk.ACC_MID


def test_acc_constants_mirror_field_cu():
    assert fk.ACC_THREADS == 1 << _field_cu_const("kAccLogThreads")
    assert fk.ACC_LOG_MAX_GROUPS == _field_cu_const("kAccLogMaxGroups")
    assert fk.ACC_MAX_TERMS == _field_cu_const("kAccMaxTerms")
    assert TILE == 1 << _field_cu_const("kAccLogTile")
    assert MID == 1 << _field_cu_const("kAccLogMid")
    with open(CSRC) as fh:
        gain = re.search(r"kAccSplitGain = ([0-9.]+);", fh.read()).group(1)
    assert fk.ACC_SPLIT_GAIN == float(gain)
    # the reduction of a 160-bit sum folds its top word with 2^128 == -2^32
    assert pow(2, 128, P) == P - 2**32


def _ints(x):
    """Canonical words as an object array of Python ints."""
    return np.asarray(U(x) if isinstance(x, torch.Tensor) else x,
                      dtype=np.uint64).astype(object)


def _fill_powers(a, q):
    """csrc/field.cu `fill_powers` on a list: a[s + j] = a[j]·q^s for j < s
    in rounds s = 1, 2, 4, ...; returns q^(2^rounds)."""
    s = 1
    while s < len(a):
        m = min(s, len(a) - s)
        a[s:s + m] = [x * q % P for x in a[:m]]
        q = q * q % P
        s *= 2
    return q


def _power_tables(ratios, starts, n):
    """`acc_powers_kernel`'s rows: r^j, r^(TILE m), start·r^(TILE MID h)."""
    rows = []
    for r, st in zip(ratios, starts):
        pw = [1] + [0] * (TILE - 1)
        mid = [1] + [0] * (MID - 1)
        top = [int(st)] + [0] * (fk.acc_table_words(n) - TILE - MID - 1)
        q = _fill_powers(pw, int(r))
        assert q == pow(int(r), TILE, P)
        q = _fill_powers(mid, q)
        _fill_powers(top, q)
        rows.append(pw + mid + top)
    return rows


M32 = 2**32 - 1


def _mac(s, a, b):
    """csrc/field.cu `mac` on (even, odd) sums of object arrays: a0 b0 +
    a1 b1 2^64 into the even sum, a0 b1 + a1 b0 into the odd one."""
    a0, a1, b0, b1 = a & M32, a >> 32, b & M32, b >> 32
    return s[0] + a0 * b0 + (a1 * b1 << 64), s[1] + a0 * b1 + a1 * b0


def _const(v, n):
    return np.full(n, v, dtype=object)


def _reduce160(e, o):
    """csrc/field.cu `reduce160` of an (even, odd) sum, word by word: e's
    top word folded with 2^128 == -2^32, o's with 2^96 == -1."""
    e2, o2 = e >> 128, o >> 64
    assert e2 < 2**9 and o2 < 2**9
    even = ((e & (2**128 - 1)) % P - e2 * 2**32) % P
    odd = ((o & M64) * 2**32 % P - o2) % P
    return (even + odd) % P


def _emulate_acc_group(acc, parts, w_pairs, ratios, starts, n,
                       log_groups=None, slots=132 * 3):
    """csrc/field.cu F3 as the card runs it, block by block: the power
    tables in doubling rounds, the geometry of `acc_group_plan` (for
    `slots` = SMs x blocks an SM holds), each block's w_shift·start·r^tile0,
    the term groups' unreduced 160-bit sums of products, their fold and
    meeting in shared memory, and the columns read through the launcher's
    (address, position stride, coefficient stride) triples."""
    T_ = sum(q.shape[0] for q in parts)
    ext = parts[0].dim() == 3
    lg, per, blocks = fk.acc_geometry(T_, n, slots, log_groups)
    G = 1 << lg
    tables = _power_tables(_ints(ratios), _ints(starts), n)
    w = _ints(w_pairs).reshape(T_, 2, 3)
    words = {}  # each part's storage as ints, with the part's first word
    for q in parts:
        flat = torch.as_strided(q, (q.untyped_storage().nbytes() // 8,),
                                (1,), 0)
        words[id(q)] = (_ints(flat), q.storage_offset())
    cols = fk.acc_columns(parts)
    out = _ints(acc).reshape(n, 3).copy()
    for b in range(blocks):
        tile0 = b * per
        h, m, off = tile0 >> 14, (tile0 >> 8) & (MID - 1), tile0 % TILE
        x0 = [row[TILE + MID + h] * row[TILE + m] % P for row in tables]
        pos = tile0 + np.arange(per)
        valid = pos < n
        partial = []
        for g in range(G):
            sums = [(np.zeros(per, dtype=object), np.zeros(per, dtype=object))
                    for _ in range(3)]
            for t in range(g, T_, G):
                x = np.array(tables[t][off:off + per], dtype=object)
                shift = [w[t, 1, k] * x0[t] % P for k in range(3)]
                q, first, st_i, st_c = cols[t]
                store, base = words[id(q)]
                at = base + first + np.where(valid, pos, 0) * st_i
                y = [np.where(valid, store[at + k * st_c], 0)
                     for k in range(3 if ext else 1)]
                if ext:
                    c = [(shift[k] * x + w[t, 0, k]) % P for k in range(3)]
                    # y's multiplication matrix (X^3 = X - 1) times c
                    u = (y[0] + y[2]) % P
                    matrix = [[y[0], P - y[2], P - y[1]],
                              [y[1], u, (y[1] - y[2]) % P],
                              [y[2], y[1], u]]
                    for k in range(3):
                        for i in range(3):
                            sums[k] = _mac(sums[k], c[i], matrix[k][i])
                else:
                    z = x * y[0] % P
                    for k in range(3):
                        sums[k] = _mac(sums[k], _const(shift[k], per), z)
                        sums[k] = _mac(sums[k], _const(w[t, 0, k], per), y[0])
            partial.append([np.array([_reduce160(e, o) for e, o in zip(*sv)],
                                     dtype=object) for sv in sums])
        for k in range(3):
            total = sum(partial[g][k] for g in range(G)) % P
            out[pos[valid], k] = (out[pos[valid], k] + total[valid]) % P
    return T(out.astype(np.uint64))


def _parts(kind, T_, n, seed, device="cpu"):
    """The group's terms as the prover hands them to F3: `base` one (T, n)
    tensor, `ext` (T, n, 3) contiguous (a quotient stack), `movedim` the
    extension LDE's (T, 3, n) rows seen as (T, n, 3), `lde` the resident
    path's parts: base columns as row slices of one LDE block, or
    extension columns as movedim views with an empty table's zero-stride
    zeros between them."""

    def words(x):
        return T(x).to(device)

    if kind == "base":
        return [words(_field((T_, n), seed))]
    if kind == "ext":
        return [words(_field((T_, n, 3), seed))]
    if kind == "movedim":
        return [words(_field((T_, 3, n), seed)).movedim(1, -1)]
    if kind == "lde-base":
        block = words(_field((T_ + 3, n), seed))
        cuts = [3, 3 + T_ // 3, 3 + T_ // 2, 3 + T_]
        return [block[a:b] for a, b in zip(cuts, cuts[1:])]
    block = words(_field((3 * (T_ - 1), n), seed))
    lo = (T_ - 1) // 2
    rows = block.reshape(T_ - 1, 3, n)
    return [rows[:lo].movedim(1, -1),
            torch.zeros((), dtype=torch.int64, device=device).expand(1, n, 3),
            rows[lo:].movedim(1, -1)]


def _concat(parts):
    return torch.cat([q.contiguous() for q in parts], dim=0)


# (terms, n, kind): one position, below a block's tile, a ragged last tile,
# several tiles, a `top` table entry past the first (n > TILE·MID), the
# prover's group sizes (1, 2, 9, 16, 21) and its stack layouts; "base" and
# "ext" are the shapes of the earlier schedule's test
SCHEDULE_CASES = {
    "base": (5, 2 * 1024 + 300, "base"),
    "ext": (5, 2 * 1024 + 300, "movedim"),
    "n1-T1-base": (1, 1, "base"),
    "n1-T2-ext": (2, 1, "ext"),
    "below-tile-T16-base": (16, 100, "base"),
    "ragged-T21-ext": (21, 2 * TILE + 37, "ext"),
    "tiles-T21-movedim": (21, 3 * TILE, "movedim"),
    "tiles-T2-ext": (2, 4 * TILE, "ext"),
    "lde-T16-base": (16, TILE + 5, "lde-base"),
    "lde-T9-ext": (9, TILE + 5, "lde-ext"),
    "top-T1-base": (1, TILE * MID + 37, "base"),
    "top-T2-movedim": (2, TILE * MID + 37, "movedim"),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_acc_group_kernel_schedule_matches_plain(case):
    """The kernel's schedule at its own launch geometry and at every term
    split it allows equals `_acc_group_plain` and the JAX `_acc_group`."""
    T_, n, kind = SCHEDULE_CASES[case]
    parts = _parts(kind, T_, n, 70 + T_)
    _, _, w_pairs, ratios, starts = (T(g) for g in _group(T_, n, False, 71))
    acc = T(_field((n, 3), 72))
    stack = _concat(parts)
    want = BrainfuckStark._acc_group_plain(_stub(n), acc, stack, w_pairs,
                                           ratios, starts)
    jax = JBrainfuckStark._acc_group(
        _jax_stub(n), U(acc), U(stack), U(w_pairs), U(ratios), U(starts), np)
    assert np.array_equal(U(want), np.asarray(jax))
    # the CPU route over the parts, without a concatenation
    assert torch.equal(
        BrainfuckStark._acc_group(_stub(n), acc, parts, w_pairs, ratios,
                                  starts), want)
    splits = [None] + [lg for lg in range(fk.ACC_LOG_MAX_GROUPS + 1)
                       if 1 << lg <= T_]
    if n > TILE * MID:
        splits = splits[:2]  # one forced split is enough at this size
    for lg in splits:
        got = _emulate_acc_group(acc, parts, w_pairs, ratios, starts, n, lg)
        assert torch.equal(got, want), (case, lg)


@pytest.mark.parametrize("T_", [1, 2, 9, 16, 21])
def test_acc_geometry_covers_every_position_once(T_):
    """Every (position, term) pair is summed by exactly one thread, and
    every position reaches acc from exactly one (group 0's)."""
    tid = np.arange(fk.ACC_THREADS)
    for n in list(range(1, 40)) + [255, 256, 257, 1000, 1024, 3 * TILE + 1]:
        for log_groups in [None] + list(range(fk.ACC_LOG_MAX_GROUPS + 1)):
            if log_groups is not None and 1 << log_groups > T_:
                continue
            lg, per, blocks = fk.acc_geometry(T_, n, 132 * 3, log_groups)
            G = 1 << lg
            assert G <= T_ and per * G == fk.ACC_THREADS
            g, j = tid >> (8 - lg), tid & (per - 1)
            hits = np.zeros((n, T_), dtype=np.int64)
            writes = np.zeros(n, dtype=np.int64)
            for b in range(blocks):
                pos = b * per + j
                for t in range(T_):
                    sel = (g == t % G) & (pos < n)
                    np.add.at(hits[:, t], pos[sel], 1)
                np.add.at(writes, pos[(g == 0) & (pos < n)], 1)
            assert (hits == 1).all() and (writes == 1).all(), (n, lg)


def test_acc_geometry_rule():
    """The term split at the prover's shapes, for 132 SMs holding 3 blocks
    each: one block per 256 positions where the blocks fill many waves, a
    split where they do not, never more groups than terms."""
    slots = 132 * 3
    for T_ in (9, 16, 21):
        assert fk.acc_geometry(T_, 1 << 21, slots)[0] == 0
    assert fk.acc_geometry(9, 1 << 17, slots) == (1, 128, 1024)
    assert fk.acc_geometry(21, 1 << 14, slots)[0] == 2
    assert fk.acc_geometry(1, 1000, slots) == (0, 256, 4)
    assert fk.acc_geometry(2, 1000, slots) == (1, 128, 8)
    assert fk.acc_geometry(16, 1000, slots) == (3, 32, 32)
    assert fk.acc_geometry(9, 1 << 17, slots, log_groups=0) == (0, 256, 512)


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
    powers = fk.LAUNCHES_ACC_POWERS
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
    # (acc, columns, T, n, ext, w, ratios, starts, tables, log2 G, stream)
    assert name == "acc_group_launch" and args[2:5] == (2, 6, 1)
    assert args[-2] == -1, "the kernel's own plan chooses the term split"
    assert list(args[1]) == [stack.data_ptr(), 3, 1,
                             stack.data_ptr() + 8 * 18, 3, 1]
    assert (fk.LAUNCHES_ELEMENTWISE, fk.LAUNCHES_XFIELD, fk.LAUNCHES_ACC,
            fk.LAUNCHES_ACC_POWERS) == (before[0] + 4, before[1] + 2,
                                        before[2] + 1, powers + 1)
    # a group in parts is one launch, its columns where they lie; more than
    # ACC_MAX_TERMS terms take one launch each ACC_MAX_TERMS
    rows = _cuda(_field((5, 3, 6), 9))
    parts = [rows[:2].movedim(1, -1), rows[2:].movedim(1, -1)]
    n_launch = len(stand_in.calls)
    BrainfuckStark._acc_group(
        _stub(6), acc, parts, _cuda(_field((5, 2, 3), 10)),
        _cuda(_field((5,), 11)), _cuda(_field((5,), 12)))
    name, args = stand_in.calls[-1]
    assert len(stand_in.calls) == n_launch + 1 and args[2:5] == (5, 6, 1)
    assert list(args[1]) == sum(([rows.data_ptr() + 8 * 18 * t, 1, 6]
                                 for t in range(5)), [])
    many = fk.ACC_MAX_TERMS + 3
    fk.acc_group(acc, _cuda(_field((many, 6), 13)),
                 _cuda(_field((many, 2, 3), 14)), _cuda(_field((many,), 15)),
                 _cuda(_field((many,), 16)), 6)
    assert [c[1][2] for c in stand_in.calls[-2:]] == [fk.ACC_MAX_TERMS, 3]


def test_resident_combination_reads_the_lde_columns_in_place(monkeypatch):
    """The resident prove hands F3 its base and extension groups as the LDE
    tensors' column views: every part shares the storage of its stage's
    forward LDE output, no torch.cat of its columns runs in the combination,
    and an empty table's extension columns are a zero-stride view of one
    zero word. Through a stand-in launcher each column's address lies in that
    storage. (The proof's bytes against the JAX package's: test_torch_stark.)"""
    import stark_brainfuck_tpu as J
    import stark_brainfuck_tpu_torch as TP

    ldes, groups, cats = [], [], []
    forward_lde = BrainfuckStark._forward_lde
    acc_group = BrainfuckStark._acc_group
    combine = BrainfuckStark._combination_pipeline
    cat = torch.cat

    def record_lde(self, *args):
        ldes.append(forward_lde(self, *args))
        return ldes[-1]

    def record_group(self, acc, stack, *args, **kw):
        groups.append(stack)
        return acc_group(self, acc, stack, *args, **kw)

    def record_cat(tensors, *args, **kw):
        cats.append(list(tensors))
        return cat(tensors, *args, **kw)

    def combination(self, *args):
        monkeypatch.setattr(torch, "cat", record_cat)
        try:
            return combine(self, *args)
        finally:
            monkeypatch.setattr(torch, "cat", cat)

    monkeypatch.setattr(BrainfuckStark, "_forward_lde", record_lde)
    monkeypatch.setattr(BrainfuckStark, "_acc_group", record_group)
    monkeypatch.setattr(BrainfuckStark, "_combination_pipeline", combination)
    program = J.VirtualMachine.compile("++++")
    tr = J.VirtualMachine.simulate(program, "")
    stark = TP.BrainfuckStark(
        tr["processor"].shape[0], tr["memory"].shape[0], program, "",
        tr["output_data"], TP.StarkConfig(seed=0), device="cpu")
    proof = stark.prove(tr["processor"], tr["memory"], tr["instruction"],
                        tr["input"], tr["output"])
    assert stark.verify(proof)

    def storage(x):
        return x.untyped_storage().data_ptr()

    base_lde, ext_lde = ldes
    base_parts, ext_parts = groups[:2]
    heights = [t.height for t in stark.tables]
    assert 0 in heights, "the program leaves a table empty"
    assert len(base_parts) == len(ext_parts) == len(stark.tables)
    assert all(storage(q) == storage(base_lde) for q in base_parts)
    for height, q in zip(heights, ext_parts):
        if height:
            assert storage(q) == storage(ext_lde) and q.stride()[1] == 1
        else:
            assert q.stride() == (0, 0, 0) and not q.any()
    # (a quotient may lift one column with torch.cat: `xfield.from_base`)
    assert not any(
        len(ts) > 1 and all(storage(x) == storage(lde) for x in ts)
        for ts in cats for lde in (base_lde, ext_lde)
    ), "the combination concatenated columns of an LDE"

    lib = _Lib()
    monkeypatch.setattr(fk, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(fk, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    N = stark.fri.domain.length
    for parts, lde in ((base_parts, base_lde), (ext_parts, ext_lde)):
        T_ = sum(q.shape[0] for q in parts)
        fk.acc_group(_cuda(_field((N, 3), 1)),
                     [q.as_subclass(_ReportsCuda) for q in parts],
                     _cuda(_field((T_, 2, 3), 2)), _cuda(_field((T_,), 3)),
                     _cuda(_field((T_,), 4)), N)
        name, args = lib.calls[-1]
        cols = np.array(list(args[1])).reshape(-1, 3)
        assert name == "acc_group_launch" and len(cols) == T_
        inside = (cols[:, 0] >= lde.data_ptr()) & (
            cols[:, 0] < lde.data_ptr() + 8 * lde.numel())
        zero = (cols[:, 1] == 0) & (cols[:, 2] == 0)
        assert (inside | zero).all() and (inside ^ zero).all()


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
    # F3 on parts, at every term split, T = 1 and ragged n
    for case in SCHEDULE_CASES.values():
        T_, n, kind = case
        parts = _parts(kind, T_, n, 110, device="cuda")
        acc, _, w, r, st = (card(T(g)) for g in _group(T_, n, False, 111))
        want = BrainfuckStark._acc_group_plain(_stub(n), acc,
                                               _concat(parts), w, r, st)
        for lg in [None] + [k for k in range(fk.ACC_LOG_MAX_GROUPS + 1)
                            if 1 << k <= T_]:
            got = fk.acc_group(acc.clone(), parts, w, r, st, n, lg)
            assert torch.equal(got, want), (case, lg)
