"""The window's arithmetic: a rate over all the work and all the time, and
a nearest-rank percentile over all the jobs."""

import pytest

import bench_gpu_tiny  # noqa: F401
import stats


def test_rate_is_all_work_over_all_time():
    # three jobs, a gap between the second and third: the gap counts
    amounts = [100, 300, 200]
    starts = [10.0, 11.0, 15.0]
    ends = [11.0, 12.0, 16.0]
    assert stats.rate(amounts, starts, ends) == pytest.approx(600 / 6.0)


def test_rate_of_no_job_raises():
    with pytest.raises(ValueError):
        stats.rate([], [], [])


@pytest.mark.parametrize("n, want", [(200, 190), (201, 191), (20, 19),
                                     (1, 1)])
def test_p95_nearest_rank(n, want):
    values = [float(v) for v in range(1, n + 1)]
    assert stats.percentile(values[::-1], 95) == want


def beyond(values, q):
    p = stats.percentile(values, q)
    return sum(1 for v in values if v > p)


def test_ten_beyond_p95_at_200_jobs():
    values = [float(v) for v in range(200)]
    assert beyond(values, 95) == 10
    assert beyond(values[:199], 95) < 10


def test_ten_beyond_p90_at_100_jobs():
    values = [float(v) for v in range(100)]
    assert stats.percentile(values, 90) == 89.0
    assert beyond(values, 90) == 10
