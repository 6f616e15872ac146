"""job_s_p95: the nearest-rank 95th percentile of the window's job times
(simulate, constructor and prove, to the proof's bytes on the host), on the
harness's clock, over every job of the window."""

import stats


def read(ctx):
    return stats.percentile([j.end - j.start for j in ctx.jobs], 95)
