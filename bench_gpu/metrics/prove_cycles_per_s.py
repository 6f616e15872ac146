"""prove_cycles_per_s: the cycles of every job of the window (processor-table
rows before padding) over the time from the first job's start to the last
job's end, on the harness's clock."""

import stats


def read(ctx):
    return stats.rate([j.cycles for j in ctx.jobs], [j.start for j in ctx.jobs],
                      [j.end for j in ctx.jobs])
