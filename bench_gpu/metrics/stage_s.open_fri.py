"""stage_s.open_fri: seconds a prove spends in the openings and FRI: the mark
'fri.prove' (the prover does not mark the openings apart); the mean over the
window's proves of the times the prover reports (last_metrics["stages_s"],
each mark after a device synchronise)."""

MATCH = lambda k: k == 'fri.prove'


def read(ctx):
    seen = [sum(s for k, s in j.stages.items() if MATCH(k)) for j in ctx.jobs
            if any(MATCH(k) for k in j.stages)]
    return sum(seen) / len(seen) if seen else None
