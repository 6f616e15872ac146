"""The reduction of a profiler trace: device time as the union of the
device's events, no host annotation counted as device work, and the idle
gaps put down to the job phase and prover stage they fall in."""

from types import SimpleNamespace

import pytest

import bench_gpu_tiny  # noqa: F401
import devtrace

from torch.autograd import DeviceType


def ev(name, a, b, device=True, annotation=False):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=a, end=b),
        is_user_annotation=annotation)


def test_reduce():
    events = [
        ev("job.simulate", 0, 100, device=False),
        ev("job.construct", 100, 200, device=False),
        ev("job.prove", 200, 1200, device=False),
        # the profiler's device-side copy of the host range: not device work
        ev("job.prove", 200, 1200, annotation=True),
        ev("void k1<int>(int)", 300, 500),
        ev("void k1<int>(int)", 450, 600),  # overlaps the first
        ev("Memcpy HtoD (Pageable -> Device)", 900, 1000),
    ]
    stages = [{"stage_a": 500e-6, "fri.prove": 400e-6}]
    p = devtrace.reduce(events, stages)
    assert p.jobs == 1 and p.kernels == 2
    assert p.window_s == pytest.approx(1200e-6)
    assert p.busy_s == pytest.approx(400e-6)  # [300, 600) and [900, 1000)
    assert p.device_s(["k1"]) == pytest.approx(350e-6)
    idle = p.idle_s_by_host
    assert idle["job.simulate"] == pytest.approx(100e-6)
    assert idle["job.construct"] == pytest.approx(100e-6)
    # prove from 200: stage_a [200, 700), fri.prove [700, 1100), rest
    assert idle["prove: stage_a"] == pytest.approx(200e-6)
    assert idle["prove: fri.prove"] == pytest.approx(300e-6)
    assert idle["prove: after the last mark"] == pytest.approx(100e-6)
    assert sum(idle.values()) == pytest.approx(p.window_s - p.busy_s)
    b = p.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(350e-6)]


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::gl_binary_kernel<unsigned int>(int, long)",
     "gl_binary_kernel"),
    ("(anonymous namespace)::quotients_kernel((anonymous namespace)::A)",
     "quotients_kernel"),
    ("void at::native::elementwise_kernel<128, 2, f<g(int)>>(x)",
     "at::native::elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_short_name(name, short):
    assert devtrace.short_name(name) == short
