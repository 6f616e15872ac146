"""host_job_s: a job's host set-up, `VirtualMachine.simulate` and the
`BrainfuckStark` constructor, mean over the window's jobs (harness clock)."""


def read(ctx):
    return sum(j.host_s for j in ctx.jobs) / len(ctx.jobs)
