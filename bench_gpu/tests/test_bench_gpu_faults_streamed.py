"""The faults of `test_bench_gpu_faults.py` under the program's streamed
prover, the path the FRI-2^26 cell times: a tiny cell's run with the
program proving in 4 classes, and the timed path broken underneath, comes
out not correct. The judge proves on the reference's resident path, as at
every domain up to its threshold."""

from types import SimpleNamespace

import pytest

import bench_gpu_tiny as T
import test_bench_gpu_faults as F

import stark_brainfuck_tpu_torch as P
from stark_brainfuck_tpu_torch.ops import fri_kernels
from stark_brainfuck_tpu_torch.protocol import fri as port_fri
from stark_brainfuck_tpu_torch.protocol.stark import BrainfuckStark


def streamed():
    """The program, with every prove sent down its streamed prover."""
    return SimpleNamespace(
        VirtualMachine=P.VirtualMachine,
        BrainfuckStark=BrainfuckStark,
        StarkConfig=lambda **kw: P.StarkConfig(stream_min=1,
                                               stream_classes=4, **kw),
    )


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return T.tiny_copy(tmp_path_factory.mktemp("faults_streamed"))


def test_sound_streamed_run_is_correct(here, monkeypatch):
    classes = []
    real = BrainfuckStark.prove

    def prove(self, *a, **kw):
        proof = real(self, *a, **kw)
        classes.append(self.last_metrics.get("stream_classes"))
        return proof

    monkeypatch.setattr(BrainfuckStark, "prove", prove)
    result = T.tiny_run(here, program=streamed())
    assert result["correct"], result
    assert classes and set(classes) == {4}


def _patch_state_unchanged(monkeypatch):
    monkeypatch.setattr(fri_kernels, "fold_host", F._unchanged_fold)
    monkeypatch.setattr(port_fri, "_fold_device", F._unchanged_fold)


def _patch_half_the_batch(monkeypatch):
    F._half_weighed.real = BrainfuckStark._acc_group
    monkeypatch.setattr(BrainfuckStark, "_acc_group", F._half_weighed)


def _patch_answer_altered(monkeypatch):
    F._altered_proof.real = BrainfuckStark.prove
    monkeypatch.setattr(BrainfuckStark, "prove", F._altered_proof)


@pytest.mark.parametrize("fault", [_patch_state_unchanged,
                                   _patch_half_the_batch,
                                   _patch_answer_altered])
def test_a_streamed_fault_is_not_correct(here, monkeypatch, fault):
    fault(monkeypatch)
    result = T.tiny_run(here, program=streamed())
    assert not result["correct"]
    assert result["checks"]["bytes_differing"]["value"] > 0
