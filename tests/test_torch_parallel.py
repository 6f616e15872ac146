"""The sharded prover of the torch port on CPU ranks (gloo), against the
JAX package and against the port on one device.

Each world size (2, 4, 8 ranks) is spawned once: every rank runs `battery`
below and returns its blocks, its proofs and the comparisons it made
against the port's single-device functions; each test asserts one entry.
Inputs come from numpy seeds that the workers and this process share.
Tolerance everywhere: none, the integers must be equal.

The JAX side runs on numpy (`nt.ntt(x, root, np)`, `prove(..., xp=np)`, and
the prover core with `xp=np`, which it has), so no Pallas kernel and no XLA
mesh is involved. JAX is imported inside the tests that need it, not at the
top: the rank processes import this module for `battery` and need no JAX.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import stark_brainfuck_tpu_torch as TP
from stark_brainfuck_tpu_torch.convert import (
    blocks_to_global,
    tensor_to_u64,
    u64_to_tensor,
)
from stark_brainfuck_tpu_torch.ops import field as f
from stark_brainfuck_tpu_torch.parallel.multihost import spawn_ranks

torch.set_num_threads(1)

WORLDS = (2, 4, 8)
# the distributed transform's input: one (3, n) tensor of full rows, or the
# prover's form, groups of different widths (zero past their own)
FORMS = ("rows", "groups")
SEED = 41
HERE = os.path.dirname(os.path.abspath(__file__))

# key -> (source, seed, config); the JAX reference proves with the seed only
PROGRAMS = {
    # N = 1024: device trees only because device_commit_min is lowered;
    # unit distances 64..256 against blocks of 512..128 leaves
    "plus4": ("++++", 0, {"device_commit_min": 1024}),
    # N = 1024 below device_commit_min: every tree is gathered, host-built
    "loop": ("+>[+<-]", 0, {}),
    # N = 16384: device trees in blocks, FRI round 0 folded across ranks
    "n16384": ("+" * 8 + "[->++++[-]<]", 7, {}),
    # the same with five FRI rounds in blocks
    "n16384_deep": ("+" * 8 + "[->++++[-]<]", 7,
                    {"device_commit_min": 1024, "fri_host_min": 1024}),
}
BACKENDS = ("auto", "mxu")
PROVE_CASES = [(k, nb) for k in PROGRAMS for nb in BACKENDS
               if not (k == "n16384_deep" and nb == "mxu")]


def _field(rng, shape):
    return rng.integers(0, f.P, size=shape, dtype=np.uint64)


def _stark(key, backend="auto", ranks=1, seed="own"):
    src, own_seed, config = PROGRAMS[key]
    program = TP.VirtualMachine.compile(src)
    tr = TP.VirtualMachine.simulate(program)
    cfg = TP.StarkConfig(
        seed=own_seed if seed == "own" else seed, ntt_backend=backend,
        mesh_shape=(("shard", ranks),), **config)
    bfs = TP.BrainfuckStark(
        tr["processor"].shape[0], tr["memory"].shape[0], program, "",
        tr["output_data"], cfg, device="cpu")
    return bfs, tr, (tr["processor"], tr["memory"], tr["instruction"],
                     tr["input"], tr["output"])


# ---------------------------------------------------------------------------
# what every rank runs
# ---------------------------------------------------------------------------


def _groups(x):
    """The rows of x (3, n) as three groups of widths n, n/2 + 3 and 5."""
    n = int(x.shape[1])
    return [x[:1], x[1:2, : n // 2 + 3], x[2:, :5]]


def _dntt_jobs(mesh, out):
    from stark_brainfuck_tpu_torch.ops import kernel_ntt as kn
    from stark_brainfuck_tpu_torch.parallel import dntt

    rng = np.random.default_rng(SEED)
    for logn in (10, 12):
        n = 1 << logn
        x = u64_to_tensor(_field(rng, (3, n)))
        root = f.primitive_nth_root(n)
        out["dntt", logn, "rows"] = tensor_to_u64(
            dntt.distributed_ntt(x, root, mesh))
        tables = dntt.make_dntt_tables(n, root, mesh)
        out["dntt", logn, "groups"] = tensor_to_u64(
            dntt.distributed_ntt_with(_groups(x), tables, mesh))
    coeffs = _field(rng, (2, 1 << 10))
    for d in (200, 1 << 10):
        got = dntt.distributed_coset_evaluate(
            u64_to_tensor(coeffs[:, :d]), f.GENERATOR,
            f.primitive_nth_root(1 << 10), 1 << 10, mesh)
        out["coset", d] = tensor_to_u64(got)
    # the B3 route of the twiddle step needs 128 columns a rank: 2^20 on 8
    # ranks has them, one row is enough
    n = 1 << 16 if mesh.world == 2 else 1 << 18 if mesh.world == 4 else 1 << 20
    root = f.primitive_nth_root(n)
    tables = dntt.make_dntt_tables(n, root, mesh)
    R, C = tables.R, tables.C
    lo, hi = mesh.block(C)
    # the same tables with the twiddle step as a field multiply by the
    # rank's plain columns
    columns = dntt.twiddle_columns(root, lo, hi, R)
    plain = tables._replace(twiddle=columns, twiddle_plan=None)
    x = u64_to_tensor(_field(rng, (1, 3000)))
    out["b3_route"] = {
        "uses_b3": tables.twiddle_plan is not None and tables.twiddle is None,
        "columns": C // mesh.world,
        "equal": bool(torch.equal(
            dntt.distributed_ntt_with(x, tables, mesh),
            dntt.distributed_ntt_with(x, plain, mesh))),
    }
    # the two local DFTs alone, B2's strided form (its plain version here)
    # against the radix-2 network on the moved axis, and B3's offset tables
    # against the rank's plain twiddle columns
    cl, rd = C // mesh.world, R // mesh.world
    for transposed, plan, (m, v) in ((True, tables.pack_r, (R, cl)),
                                     (False, tables.pack_c, (C, rd))):
        x = u64_to_tensor(_field(rng, (2, m, v)))
        got = dntt._dft_middle(x, plan, transposed)
        pack = kn.make_network_pack(m, f.h_pow(root, n // m))
        want = kn.network_ntt(x.transpose(1, 2), pack)  # (2, v, m)
        want = want if transposed else want.transpose(1, 2)
        out["dft_middle", transposed] = {
            "shape": tuple(got.shape), "contiguous": got.is_contiguous(),
            "equal": bool(torch.equal(got, want))}
    y = u64_to_tensor(_field(rng, (2 * cl, R)))
    out["b3_tables"] = bool(torch.equal(
        kn.twiddle_outer(y, tables.twiddle_plan).view(2, cl, R),
        f.mul(y.view(2, cl, R), columns[None])))


def _roll_jobs(mesh, out):
    rng = np.random.default_rng(SEED + 1)
    n = 1024
    lo, hi = mesh.block(n)
    base = u64_to_tensor(_field(rng, (3, n)))
    ext = u64_to_tensor(_field(rng, (2, n, 3)))
    for shift in (0, 1, 64, 128, 256, 300, 512, 1023):
        ok = True
        for x in (base, ext):
            got = mesh.roll(x[:, lo:hi].contiguous(), shift, 1, n)
            ok = ok and torch.equal(got, torch.roll(x, -shift, 1)[:, lo:hi])
        out["roll", shift] = bool(ok)


def _zerofier_jobs(mesh, out):
    for key in ("plus4", "n16384"):
        whole = _stark(key)[0]._zerofier_inverses()
        bfs = _stark(key, ranks=mesh.world)[0]
        mine = bfs._zerofier_inverses()
        lo, hi = mesh.block(bfs.fri.domain.length)
        ok, shapes = True, set()
        for h, kinds in whole.items():
            for kind, row in kinds.items():
                ok = ok and torch.equal(mine[h][kind], row[lo:hi])
                shapes.add(tuple(mine[h][kind].shape))
        out["zerofier", key] = {"equal": bool(ok), "shapes": shapes,
                                "block": hi - lo}


def _fold_jobs(mesh, out):
    from stark_brainfuck_tpu_torch.protocol import fri

    rng = np.random.default_rng(SEED + 2)
    n = 2048
    cw = u64_to_tensor(_field(rng, (n, 3)))
    alpha = tuple(int(v) for v in _field(rng, (3,)))
    omega = f.primitive_nth_root(n)
    whole = fri._fold_device(cw, alpha, omega, f.GENERATOR)
    lo, hi = mesh.block(n)
    got = fri._fold_sharded(cw[lo:hi].contiguous(), alpha, omega,
                            f.GENERATOR, mesh)
    lo2, hi2 = mesh.block(n // 2)
    out["fold"] = bool(torch.equal(got, whole[lo2:hi2]))


def _tree_jobs(mesh, out):
    from stark_brainfuck_tpu_torch.protocol import device_merkle as dm

    rng = np.random.default_rng(SEED + 3)
    n = 2048
    rows = u64_to_tensor(_field(rng, (n, 5)))
    key = dm.salt_key_words(bytes(range(16)))
    salts = dm.salt_words_device(key, n)
    lo, hi = mesh.block(n)
    my_salts = dm.salt_words_device(
        key, hi - lo, indices=torch.arange(lo, hi, dtype=torch.int64))
    picks = [0, 1, 63, 64, n // 2 - 1, n // 2, n - 129, n - 1]
    for salted in (False, True):
        if salted:
            whole = dm.DeviceSaltedMerkle(rows, salts)
            mine = dm.DeviceSaltedMerkle(rows[lo:hi], my_salts, cut=whole.cut,
                                         mesh=mesh)
        else:
            whole = dm.DeviceMerkle(rows)
            mine = dm.DeviceMerkle(rows[lo:hi], cut=whole.cut, mesh=mesh)
        dm.prefetch_trees([(mine, picks[:4])])
        out["tree", salted] = {
            "salts": bool(torch.equal(my_salts, salts[lo:hi])),
            "root": mine.root() == whole.root(),
            # the second half of the picks goes through the one-by-one path
            "openings": all(mine.open(i) == whole.open(i) for i in picks),
            "rows": all(np.array_equal(mine.row_at(i), whole.row_at(i))
                        for i in picks),
            "local_leaves": int(mine.rows.shape[0]),
            "local_top": int(mine.levels[-1].shape[0]),
        }


def _core_jobs(mesh, out):
    from stark_brainfuck_tpu_torch.parallel import prover

    bfs, tr, _ = _stark("plus4", ranks=mesh.world)
    acc, _ = prover.run_core(bfs, tr, seed=0)
    out["core"] = tensor_to_u64(acc)
    # the shapes the resident stages return above device_commit_min
    bfs, tr, _ = _stark("n16384", ranks=mesh.world)
    inputs = prover.prove_core_inputs(bfs, tr, seed=0)
    packs = bfs._lde_packs()
    rand_cw, base_cws = bfs._stage_base_lde(
        inputs["mats"], inputs["rand_coeffs"], inputs["base_rands"], packs)
    xcols, _ = bfs._device_extend(
        inputs["mats"], inputs["challenges"], inputs["initials"])
    ext_cws = bfs._stage_ext_lde(xcols, inputs["ext_rands"], packs)
    acc = bfs._combination_pipeline(
        rand_cw, base_cws, ext_cws, inputs["challenges"],
        inputs["terminals"], inputs["weights"], inputs["shifts"],
        inputs["offset_pows"])
    out["stage_shapes"] = {
        "N": bfs.fri.domain.length,
        "rand_cw": tuple(rand_cw.shape),
        "base": {tuple(cw.shape)[1:] for cw in base_cws},
        "ext": {tuple(cw.shape)[1:] for cw in ext_cws},
        "acc": tuple(acc.shape),
        "fwd_pack": packs["fwd"],
        "twiddle": tuple(packs["dntt"].twiddle.shape),
        "factors": (packs["dntt"].R, packs["dntt"].C),
    }


def _prove_jobs(mesh, out):
    for key, backend in PROVE_CASES:
        bfs, _, args = _stark(key, backend, ranks=mesh.world)
        proof = bfs.prove(*args)
        m = bfs.last_metrics
        out["prove", key, backend] = {
            "proof": proof if mesh.rank == 0 else None,
            "digest": hashlib.sha256(proof).hexdigest(),
            "ntt_path": m["ntt_path"],
            "mesh": m["mesh"],
            "hash_path": m["hash_path"],
        }
    # no seed: the ranks must still agree (rank 0's drawn seed is shared)
    bfs, _, args = _stark("plus4", ranks=mesh.world, seed=None)
    proof = bfs.prove(*args)
    out["unseeded"] = {"proof": proof if mesh.rank == 0 else None,
                       "digest": hashlib.sha256(proof).hexdigest()}


def battery(mesh, payload):
    """Everything one rank computes for the tests below."""
    assert mesh.world == payload["world"]
    out = {"mesh": mesh.describe()}
    for job in (_dntt_jobs, _roll_jobs, _zerofier_jobs, _fold_jobs,
                _tree_jobs, _core_jobs, _prove_jobs):
        job(mesh, out)
    return out


# ---------------------------------------------------------------------------
# this process: spawn once per world size, compute the references once
# ---------------------------------------------------------------------------

_REF = {}


@pytest.fixture(scope="module")
def ranks():
    """{world: [battery result of rank 0, 1, ...]}."""
    return {
        w: spawn_ranks("test_torch_parallel:battery", w, {"world": w},
                       device="cpu", timeout=600, python_path=[HERE])
        for w in WORLDS
    }


def _jax():
    import stark_brainfuck_tpu as J
    from stark_brainfuck_tpu.ops import ntt as jnt

    return J, jnt


def _jax_stark(key):
    J, _ = _jax()
    src, seed, _ = PROGRAMS[key]
    program = J.VirtualMachine.compile(src)
    tr = J.VirtualMachine.simulate(program)
    jb = J.BrainfuckStark(
        tr["processor"].shape[0], tr["memory"].shape[0], program, "",
        tr["output_data"], J.StarkConfig(seed=seed))
    return jb, tr


def _reference_proofs(key):
    """(jax stark, jax numpy proof, port stark, port single-device proof)."""
    if key not in _REF:
        jb, tr = _jax_stark(key)
        pj = jb.prove(tr["processor"], tr["memory"], tr["instruction"],
                      tr["input"], tr["output"], xp=np)
        tb, _, args = _stark(key)
        _REF[key] = (jb, pj, tb, tb.prove(*args))
    return _REF[key]


# -- (a) the distributed transform --------------------------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("logn", [10, 12])
@pytest.mark.parametrize("world", WORLDS)
def test_distributed_ntt_matches_jax(ranks, world, logn, form):
    _, jnt = _jax()
    rng = np.random.default_rng(SEED)
    xs = {ln: _field(rng, (3, 1 << ln)) for ln in (10, 12)}
    n = 1 << logn
    x = xs[logn]
    if form == "groups":
        x = np.zeros_like(x)
        for i, g in enumerate(_groups(xs[logn])):
            x[i, : g.shape[1]] = g[0]
    got = blocks_to_global(
        [r["dntt", logn, form] for r in ranks[world]], axis=1)
    assert got.shape == (3, n)
    want = np.asarray(jnt.ntt(x, f.primitive_nth_root(n), np))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("d", [200, 1 << 10], ids=["d200", "d1024"])
@pytest.mark.parametrize("world", WORLDS)
def test_distributed_coset_evaluate_matches_jax(ranks, world, d):
    """Fewer coefficients than points (zero-padded), and as many."""
    _, jnt = _jax()
    rng = np.random.default_rng(SEED)
    for ln in (10, 12):
        _field(rng, (3, 1 << ln))
    coeffs = _field(rng, (2, 1 << 10))[:, :d]
    n = 1 << 10
    got = blocks_to_global([r["coset", d] for r in ranks[world]], axis=1)
    want = np.asarray(jnt.coset_evaluate(
        coeffs, f.GENERATOR, f.primitive_nth_root(n), n, np))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_twiddle_step_on_b3_tables_carries_the_column_offset(ranks, world):
    for r in ranks[world]:
        assert r["b3_route"] == {"uses_b3": True, "columns": 128,
                                 "equal": True}


@pytest.mark.parametrize("transposed", [True, False])
@pytest.mark.parametrize("world", WORLDS)
def test_local_dft_on_b2_strides_matches_the_u64_network(ranks, world,
                                                         transposed):
    """B2 reads the middle axis through its strides and stores (B, v, m) or
    (B, m, v) itself: no transposed view comes back."""
    n = {2: 1 << 16, 4: 1 << 18, 8: 1 << 20}[world]
    R, C = 1 << (n.bit_length() - 1) // 2, 1 << (n.bit_length()) // 2
    m, v = (R, C // world) if transposed else (C, R // world)
    for r in ranks[world]:
        assert r["dft_middle", transposed] == {
            "shape": (2, v, m) if transposed else (2, m, v),
            "contiguous": True, "equal": True}


@pytest.mark.parametrize("world", WORLDS)
def test_b3_offset_tables_equal_the_ranks_twiddle_columns(ranks, world):
    assert all(r["b3_tables"] for r in ranks[world])


# -- (b) roll, zerofier slices, fold, tree --------------------------------------


@pytest.mark.parametrize("shift", [0, 1, 64, 128, 256, 300, 512, 1023])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_roll_equals_torch_roll(ranks, world, shift):
    assert all(r["roll", shift] for r in ranks[world])


@pytest.mark.parametrize("key", ["plus4", "n16384"])
@pytest.mark.parametrize("world", WORLDS)
def test_zerofier_slices_equal_single_device(ranks, world, key):
    for r in ranks[world]:
        z = r["zerofier", key]
        assert z["equal"]
        assert z["shapes"] == {(z["block"],)}, "a zerofier row is not a block"


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fold_equals_single_device(ranks, world):
    assert all(r["fold"] for r in ranks[world])


@pytest.mark.parametrize("salted", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_tree_equals_single_device(ranks, world, salted):
    for r in ranks[world]:
        t = r["tree", salted]
        assert t["salts"] and t["root"] and t["openings"] and t["rows"], t
        assert t["local_leaves"] == 2048 // world
        assert t["local_top"] == 512 // world


# -- (c) the prover core --------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_prove_core_matches_unsharded_and_jax(ranks, world):
    """The JAX core runs through its numpy path (`xp=np`)."""
    from stark_brainfuck_tpu.parallel.prover import (
        make_prove_core,
        prove_core_inputs,
    )
    from stark_brainfuck_tpu_torch.parallel.prover import run_core

    if "core" not in _REF:
        jb, tr = _jax_stark("plus4")
        inp = prove_core_inputs(jb, tr, seed=0, xp=np)
        acc, _ = make_prove_core(jb, mesh=None, xp=np)(
            inp["mats"], inp["rand_coeffs"], inp["base_rands"],
            inp["ext_rands"], inp["challenges"], inp["initials"],
            inp["weights"], inp["shift_ratios"], inp["offset_pows"],
            inp["zinv_flat"], inp["terminals"], inp["packs"])
        tb, ttr, _ = _stark("plus4")
        _REF["core"] = (np.asarray(acc),
                        tensor_to_u64(run_core(tb, ttr, seed=0)[0]))
    want_jax, want_port = _REF["core"]
    got = blocks_to_global([r["core"] for r in ranks[world]], axis=0)
    assert np.array_equal(got, want_port)
    assert np.array_equal(got, want_jax)


@pytest.mark.parametrize("world", WORLDS)
def test_no_rank_holds_a_whole_codeword(ranks, world):
    """Above device_commit_min the resident stages return blocks of N/D,
    and the transform's tables hold no N-point pack and only the rank's
    C/D columns of the twiddle matrix."""
    for r in ranks[world]:
        s = r["stage_shapes"]
        n = s["N"] // world
        assert s["N"] == 16384 and s["factors"] == (128, 128)
        assert s["rand_cw"] == (n, 3) and s["acc"] == (n, 3)
        assert s["base"] == {(n,)} and s["ext"] == {(n, 3)}
        assert s["fwd_pack"] is None
        assert s["twiddle"] == (128 // world, 128)


# -- (d) proofs -------------------------------------------------------------------


@pytest.mark.parametrize("key,backend", PROVE_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_proof_bytes_equal_single_device_and_jax(ranks, world, key,
                                                      backend):
    _, pj, _, pt = _reference_proofs(key)
    got = [r["prove", key, backend] for r in ranks[world]]
    assert got[0]["proof"] == pt, "differs from the port on one device"
    assert got[0]["proof"] == pj, "differs from the JAX numpy proof"
    want = hashlib.sha256(pt).hexdigest()
    assert [g["digest"] for g in got] == [want] * world
    for rank, g in enumerate(got):
        assert g["ntt_path"] == "dntt-mesh:four-step-plain"
        assert (g["mesh"]["world"], g["mesh"]["rank"]) == (world, rank)
        assert g["mesh"]["backend"] == "gloo"
        assert g["mesh"]["devices"] == ["cpu"] * world
        assert g["mesh"]["sharded_commit"] == (key != "loop")
        assert g["hash_path"] == (
            "host-cpp" if key == "loop" else "torch-plain")
        used = g["mesh"]["collectives"]
        assert used["all_to_all"]["calls"] == 4 and "roll" in used
        assert ("fold_pairs" in used) == key.startswith("n16384")
        if key == "n16384_deep":
            assert used["fold_pairs"]["calls"] == 5


@pytest.mark.parametrize("key", list(PROGRAMS))
def test_mesh_proofs_verify_on_both_sides(ranks, key):
    jb, _, tb, _ = _reference_proofs(key)
    proof = ranks[8][0]["prove", key, "auto"]["proof"]
    assert tb.verify(proof), tb.last_rejection
    assert jb.verify(proof), jb.last_rejection


def test_mesh_of_one_rank_is_the_single_device_prover():
    _, pj, _, pt = _reference_proofs("plus4")
    bfs, _, args = _stark("plus4", ranks=1)
    assert bfs.mesh is None
    assert bfs.prove(*args) == pt == pj
    assert bfs.last_metrics["mesh"] is None
    assert bfs.last_metrics["ntt_path"] == "four-step-plain"


@pytest.mark.parametrize("world", WORLDS)
def test_unseeded_mesh_prove_agrees_across_ranks_and_verifies(ranks, world):
    got = [r["unseeded"] for r in ranks[world]]
    assert len({g["digest"] for g in got}) == 1
    tb = _reference_proofs("plus4")[2]
    assert got[0]["proof"] != _reference_proofs("plus4")[3]
    assert tb.verify(got[0]["proof"]), tb.last_rejection


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_describes_itself(ranks, world):
    for rank, r in enumerate(ranks[world]):
        assert r["mesh"] == {"world": world, "rank": rank,
                             "backend": "gloo", "devices": ["cpu"] * world}
