"""The port's native host runtime (stark_brainfuck_tpu_torch/native/): the
C++ trace recorder equals the python recorder and the JAX package's
`simulate` (both of its recorders), array for array; the C++ Merkle engine
equals hashlib and the JAX package's trees, byte for byte; threads get
their own traces; a failed build raises; the libraries load from the
port's own build directory in a process that holds no JAX."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import stark_brainfuck_tpu.protocol.merkle as JM
import stark_brainfuck_tpu_torch.protocol.merkle as TM
import stark_brainfuck_tpu_torch.vm.machine as machine
from stark_brainfuck_tpu import VirtualMachine as JVM
from stark_brainfuck_tpu_torch import native
from stark_brainfuck_tpu_torch.ops import cuda_build
from stark_brainfuck_tpu_torch.vm.machine import VirtualMachine as TVM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELLO = (
    "++++++++[>++++[>++>+++>+++>+<<<<-]>+>+>->>+[<]<-]>>.>---.+++++++.."
    "+++.>>.<-.<.+++.------.--------.>>+.>++."
)


def counter_program(target_cycles: int) -> str:
    """The bench's two-level counter: the largest one whose running time
    plus program length stays below `target_cycles`."""
    inner = "[->" + "+" * 32 + "[-]<]"

    def runtime(outer):
        program = TVM.compile("+" * outer + inner)
        return TVM.run(program)[0] + len(program)

    lo, hi = 1, 1
    while runtime(hi) < target_cycles:
        lo, hi = hi, hi * 2
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if runtime(mid) < target_cycles else (lo, mid)
    return "+" * lo + inner


PROGRAMS = {
    "hello": (HELLO, ""),
    "io": (",+.", "a"),
    "loop": ("+>[+<-]", ""),
    "counter_2_12": (counter_program(1 << 12), ""),
    "counter_2_14": (counter_program(1 << 14), ""),
}
KEYS = ("processor", "memory", "instruction", "input", "output")


def assert_same_trace(got, want):
    for key in KEYS:
        assert got[key].dtype == np.uint64, key
        assert got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key
    assert got["output_data"] == want["output_data"]


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_cpp_recorder_equals_python_and_jax(name):
    src, inp = PROGRAMS[name]
    program = TVM.compile(src)
    got = TVM.simulate(program, inp)
    assert_same_trace(got, TVM.simulate(program, inp, native=False))
    for jax_native in (True, False):
        assert_same_trace(got, JVM.simulate(program, inp, native=jax_native))
    if name.startswith("counter"):
        rows = got["processor"].shape[0] + len(program)
        assert rows < 1 << int(name.rsplit("_", 1)[1])


@pytest.mark.parametrize("src,inp,match", [
    (",", "", "input exhausted"),
    (",.,.", "z", "input exhausted"),
])
def test_input_exhausted_raises_the_python_error(src, inp, match):
    program = TVM.compile(src)
    for native_ in (True, False):
        with pytest.raises(AssertionError, match=match):
            TVM.simulate(program, inp, native=native_)
    with pytest.raises(AssertionError, match=match):
        JVM.simulate(program, inp)


@pytest.mark.parametrize("code", [ord("x"), ord("+") + 256])
def test_unknown_instruction_raises_the_python_error(code):
    """A code whose low byte is an instruction's is no instruction: both
    recorders refuse it."""
    for native_ in (True, False):
        with pytest.raises(AssertionError, match="unrecognized instruction"):
            TVM.simulate([ord("+"), code], native=native_)


def test_recorders_that_disagree_raise(monkeypatch):
    """A program the C++ recorder refuses but the python one traces is a
    disagreement: RuntimeError, never the python trace."""
    monkeypatch.setattr(machine, "_simulate_python", lambda p, i: {})
    with pytest.raises(RuntimeError, match="refused"):
        TVM.simulate(TVM.compile(","), "")


def test_threads_get_their_own_traces():
    """More threads than cores, started together, each recording its
    program over and over: every trace is its own program's."""
    names = ("hello", "io", "loop", "counter_2_12")
    programs = {n: TVM.compile(PROGRAMS[n][0]) for n in names}
    want = {n: TVM.simulate(programs[n], PROGRAMS[n][1], native=False)
            for n in names}
    jobs = [names[i % len(names)] for i in range(2 * (os.cpu_count() or 4))]
    start = threading.Barrier(len(jobs))
    errors = []

    def work(name):
        start.wait()
        try:
            for _ in range(10):
                assert_same_trace(
                    TVM.simulate(programs[name], PROGRAMS[name][1]), want[name])
        except Exception as exc:  # surfaced to the main thread below
            errors.append((name, exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(n,)) for n in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def hashlib_nodes(payloads):
    return TM._build_nodes_python(payloads, len(payloads))


@pytest.mark.parametrize("count", [64, 1 << 10, 1 << 14])
@pytest.mark.parametrize("plen", [1, 24, 104, 200])
def test_host_tree_equals_hashlib_and_jax(count, plen):
    rng = np.random.default_rng(count + plen)
    buf = rng.integers(0, 256, count * plen, dtype=np.uint8).tobytes()
    payloads = [buf[i * plen:(i + 1) * plen] for i in range(count)]
    want = hashlib_nodes(payloads)
    assert TM._build_nodes_buffer(buf, plen, count) == want
    assert TM.Merkle(payloads).nodes == want
    assert TM.Merkle.from_buffer(buf, plen, count).root() == bytes(want[64:128])
    assert JM._build_nodes_buffer(buf, plen, count) == want
    # salted: 24-byte salts after each payload
    salt_buf = rng.integers(0, 256, count * 24, dtype=np.uint8).tobytes()
    salts = TM.SaltBuffer(salt_buf)
    salted = [p + salts[i] for i, p in enumerate(payloads)]
    want = hashlib_nodes(salted)
    tree = TM.SaltedMerkle(salted, salts)
    assert tree.nodes == want
    salted_buf = b"".join(salted)
    assert TM.SaltedMerkle.from_buffer(
        salted_buf, plen + 24, count, salts).root() == bytes(want[64:128])
    assert JM._build_nodes_buffer(salted_buf, plen + 24, count) == want
    salt, path = tree.open(count - 1)
    assert TM.SaltedMerkle.verify(tree.root(), count - 1, path,
                                  payloads[-1] + salt)


@pytest.mark.parametrize("parallel_min", [1, 1 << 40])
def test_parallel_threshold_leaves_the_tree_unchanged(parallel_min):
    """The engine built with every level in parallel, or none, is a library
    of its own and builds hashlib's tree."""
    import ctypes

    path = cuda_build.build_host(
        ["hashing"], [f"MERKLE_PARALLEL_MIN={parallel_min}"])["hashing"]
    assert path != cuda_build.build_host(["hashing"])["hashing"]
    count, plen = 1 << 12, 104
    buf = np.random.default_rng(parallel_min % 97).integers(
        0, 256, count * plen, dtype=np.uint8).tobytes()
    nodes = ctypes.create_string_buffer(2 * count * TM.HASH_LEN)
    fn = ctypes.CDLL(path).merkle_from_payloads
    fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                   ctypes.c_char_p]
    fn(buf, plen, count, nodes)
    want = hashlib_nodes([buf[i * plen:(i + 1) * plen] for i in range(count)])
    assert nodes.raw == want


def _fresh_build(monkeypatch, tmp_path, compiler):
    native._get.cache_clear()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "GXX", compiler)


@pytest.fixture
def restore_libs():
    yield
    native._get.cache_clear()


def test_missing_compiler_raises(monkeypatch, tmp_path, restore_libs):
    _fresh_build(monkeypatch, tmp_path, str(tmp_path / "missing" / "g++"))
    with pytest.raises(RuntimeError, match="did not start"):
        native.get_vm_lib()
    with pytest.raises(RuntimeError, match="native build failed"):
        TVM.simulate(TVM.compile("++"))
    with pytest.raises(RuntimeError, match="native build failed"):
        TM.Merkle([bytes([i]) for i in range(64)])


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path,
                                                   restore_libs):
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'fatal: no room for the library'\nexit 1\n")
    fake.chmod(0o755)
    _fresh_build(monkeypatch, tmp_path, str(fake))
    with pytest.raises(RuntimeError, match="no room for the library"):
        native.get_lib()
    assert not [n for n in os.listdir(tmp_path / "build") if n.endswith(".so")]


def test_libraries_load_from_the_port_build_dir_without_jax():
    code = (
        "import sys\n"
        "from stark_brainfuck_tpu_torch import VirtualMachine as V\n"
        "from stark_brainfuck_tpu_torch.protocol.merkle import Merkle\n"
        "from stark_brainfuck_tpu_torch import native\n"
        "t = V.simulate(V.compile(',+.'), 'a')\n"
        "assert t['output_data'] == 'b'\n"
        "Merkle([bytes([i]) for i in range(64)])\n"
        "print(native.get_vm_lib()._name)\n"
        "print(native.get_lib()._name)\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('jax-native' if 'stark_brainfuck_tpu/native' in maps else '-')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'stark_brainfuck_tpu')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    vm_path, hash_path, jax_native, jax_modules = out.stdout.split("\n")[:4]
    build_dir = os.path.join(ROOT, ".torch_kernels")
    for path, stem in ((vm_path, "libnative_vm-"), (hash_path,
                                                    "libnative_hashing-")):
        assert os.path.dirname(path) == build_dir, path
        assert os.path.basename(path).startswith(stem), path
    assert jax_native == "-"
    assert jax_modules == "[]"
