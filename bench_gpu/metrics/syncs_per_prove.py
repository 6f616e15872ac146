"""syncs_per_prove: the host's blocking points a prove, the mean over the
window's proves of the program's counters: device synchronises, reads from
the device to the host and uploads from the host to the device."""

import prove_records as R

value = R.root_count(R.BLOCKING)


def read(ctx):
    return R.mean(ctx, value)
