"""device_launches_per_prove: kernels on the device a profiled job, from
the profiler's trace (copies and fills left out), whatever the program's
own launch counters say."""


def read(ctx):
    p = ctx.profile
    if p is None or p.jobs == 0:
        return None
    return p.kernels / p.jobs
