"""device_peak_gb: torch.cuda.max_memory_allocated() over the window,
reset at its start, in GB (10^9 bytes)."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
