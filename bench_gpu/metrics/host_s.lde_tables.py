"""host_s.lde_tables: seconds a prove spends building its LDE's device
tables (the span `tables` of stage_a: the NTT twiddle packs, the coset
scale tables and, streamed, the class transform's plan), the mean over the
window's proves of the program's own spans."""

import prove_records as R

value = R.span_seconds(lambda p: p.startswith("prove/stage_a")
                       and p.endswith("/tables") and p.count("/") == 2)


def read(ctx):
    return R.mean(ctx, value)
