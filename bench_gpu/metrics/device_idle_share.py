"""device_idle_share: the share of the profiled jobs' wall time (first job's
start to last job's end) in which no kernel, copy or fill ran on the
device, in %."""


def read(ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
