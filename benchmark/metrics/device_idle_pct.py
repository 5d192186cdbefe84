"""Share of the traced window in which no operation ran on the card."""


def read(ctx):
    return ctx.trace.idle_pct
