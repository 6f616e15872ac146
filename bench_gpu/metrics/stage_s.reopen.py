"""stage_s.reopen: seconds a prove spends in the streamed prover's second pass
over the classes for the openings: the mark 'reopen (streamed 2nd pass)';
nothing where no prove streams; the mean over the window's proves of the
times the prover reports (last_metrics["stages_s"], each mark after a device
synchronise)."""

MATCH = lambda k: k == 'reopen (streamed 2nd pass)'


def read(ctx):
    seen = [sum(s for k, s in j.stages.items() if MATCH(k)) for j in ctx.jobs
            if any(MATCH(k) for k in j.stages)]
    return sum(seen) / len(seen) if seen else None
