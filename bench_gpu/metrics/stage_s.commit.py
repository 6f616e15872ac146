"""stage_s.commit: seconds a prove spends in the commitments: the prover's
marks whose label holds merkle (streamed, these also evaluate the classes);
the mean over the window's proves of the times the prover reports
(last_metrics["stages_s"], each mark after a device synchronise)."""

MATCH = lambda k: 'merkle' in k


def read(ctx):
    seen = [sum(s for k, s in j.stages.items() if MATCH(k)) for j in ctx.jobs
            if any(MATCH(k) for k in j.stages)]
    return sum(seen) / len(seen) if seen else None
