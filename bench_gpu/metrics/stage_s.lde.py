"""stage_s.lde: seconds a prove spends in the LDE stages: the prover's marks
whose label starts with stage_a or stage_b; the mean over the window's
proves of the times the prover reports (last_metrics["stages_s"], each mark
after a device synchronise)."""

MATCH = lambda k: k.startswith(('stage_a', 'stage_b'))


def read(ctx):
    seen = [sum(s for k, s in j.stages.items() if MATCH(k)) for j in ctx.jobs
            if any(MATCH(k) for k in j.stages)]
    return sum(seen) / len(seen) if seen else None
