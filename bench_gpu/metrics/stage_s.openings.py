"""stage_s.openings: seconds a prove spends in the openings of steps 15-16
(the span `open` of the mark `fri.prove`: the gather of the opened rows,
salts and siblings, and the pushes), the mean over the window's proves of
the program's own spans."""

import prove_records as R

value = R.span_seconds(lambda p: p == "prove/fri.prove/open")


def read(ctx):
    return R.mean(ctx, value)
