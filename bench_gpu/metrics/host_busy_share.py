"""host_busy_share: the share of a prove's time in which the host is not
blocked on the device, in %: 100 x (the prove's time - the host nanoseconds
inside its device synchronises, reads from the device and uploads to it) /
the prove's time, the mean over the window's proves of the program's own
spans and counters."""

import prove_records as R


def value(record):
    root = record.spans[0]
    total = root.end_ns - root.start_ns
    blocked = sum(root.counts.get(k + "_ns", 0) for k in R.BLOCKING)
    return 100.0 * (total - blocked) / total if total > 0 else None


def read(ctx):
    return R.mean(ctx, value)
