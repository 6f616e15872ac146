"""program_launches_per_prove: launches of the program's hand-written
kernels a prove (B1, B2, B3, F1, F2, F3 with its power tables, F4 with its
prologue, F5), the mean over the window's proves of the program's own
counters. What device_launches_per_prove counts beyond it are torch's own
kernels: the copies of torch.cat and the fills."""

import prove_records as R

value = R.root_count(R.LAUNCHES)


def read(ctx):
    return R.mean(ctx, value)
