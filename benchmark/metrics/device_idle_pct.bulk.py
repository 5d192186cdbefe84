"""Share of the traced window in which no operation ran on the card, in the
cells that report a rate rather than a latency."""


def read(ctx):
    return ctx.trace.idle_pct
