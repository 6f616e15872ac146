"""f4_roofline: the least time the profiled proves' F4 work can take (the
larger of its bytes over the HBM bandwidth and each integer pipe's
instructions over the pipe's issue rate, from the frozen per-position counts
of rooflines/f4.json) over the device time the profiler gives F4's two
kernels in those proves, in %. Nothing where no F4 kernel ran."""

from rooflines import bound


def read(ctx):
    if ctx.profile is None:
        return None
    spent = ctx.profile.device_s(bound.load("f4")["kernel_names"])
    if spent <= 0:
        return None
    least = sum(bound.f4_least_seconds(j.domain, j.classes or 1)[0]
                for j in ctx.profiled)
    return 100.0 * least / spent
