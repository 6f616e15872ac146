"""stage_s.fri: seconds a prove spends in FRI (the span `fri` of the mark
`fri.prove`: the fold rounds and their trees, then the query phase), the
mean over the window's proves of the program's own spans."""

import prove_records as R

value = R.span_seconds(lambda p: p == "prove/fri.prove/fri")


def read(ctx):
    return R.mean(ctx, value)
