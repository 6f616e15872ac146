"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell of this benchmark can have, and so does the control.
The runs are CPU runs of a tiny cell (the harness's look for a card is
skipped); the cells' own faults and control are read on the card.

The exchange between chips is no fault of these cells: every cell runs on
one card."""

import pytest

import bench_gpu_tiny as T
import control

from stark_brainfuck_tpu_torch.ops import fri_kernels
from stark_brainfuck_tpu_torch.protocol import fri as port_fri
from stark_brainfuck_tpu_torch.protocol.stark import BrainfuckStark


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return T.tiny_copy(tmp_path_factory.mktemp("faults"))


def test_sound_run_is_correct(here):
    result = T.tiny_run(here)
    assert result["correct"], result
    assert result["checks"]["bytes_differing"]["value"] == 0


def _unchanged_fold(codeword, alpha, omega, offset, *a, **kw):
    """A fold round that returns its state unchanged (its first half, the
    length the next round expects)."""
    return codeword[: codeword.shape[0] // 2].clone()


def _half_weighed(self, acc, stack, *args, **kw):
    """The combination's weighing with half of the batch of terms left
    out."""
    if isinstance(stack, list):
        keep = stack[: max(1, len(stack) // 2)]
        args = tuple(a[: sum(int(p.shape[0]) for p in keep)]
                     if hasattr(a, "shape") else a for a in args)
        return _half_weighed.real(self, acc, keep, *args, **kw)
    n = max(1, int(stack.shape[0]) // 2)
    args = tuple(a[:n] if hasattr(a, "shape") else a for a in args)
    return _half_weighed.real(self, acc, stack[:n], *args, **kw)


def _altered_proof(self, *args, **kw):
    """A proof with one byte altered where it is produced."""
    proof = bytearray(_altered_proof.real(self, *args, **kw))
    proof[len(proof) // 2] ^= 0x40
    return bytes(proof)


def test_state_unchanged(here, monkeypatch):
    monkeypatch.setattr(fri_kernels, "fold_host", _unchanged_fold)
    monkeypatch.setattr(port_fri, "_fold_device", _unchanged_fold)
    result = T.tiny_run(here)
    assert not result["correct"]
    assert result["checks"]["bytes_differing"]["value"] > 0


def test_half_the_batch_left_out(here, monkeypatch):
    _half_weighed.real = BrainfuckStark._acc_group
    monkeypatch.setattr(BrainfuckStark, "_acc_group", _half_weighed)
    result = T.tiny_run(here)
    assert not result["correct"]
    assert result["checks"]["bytes_differing"]["value"] > 0


def test_answer_altered(here, monkeypatch):
    _altered_proof.real = BrainfuckStark.prove
    monkeypatch.setattr(BrainfuckStark, "prove", _altered_proof)
    result = T.tiny_run(here)
    assert not result["correct"]
    assert result["checks"]["bytes_differing"]["value"] >= 1


def test_control_is_not_correct(here):
    """The reference in the program's place, with no randomizers."""
    result = T.tiny_run(here, program=control.control_program())
    assert not result["correct"]
    assert result["checks"]["bytes_differing"]["value"] > 1000
