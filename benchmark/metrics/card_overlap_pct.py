"""How far the cards of the mesh work at once: the sum of each card's busy
time over the cell's cards times the device's busy time (the union over
cards). 100 when every card is busy whenever any is, 100 / cards when they
take turns; nothing without a card in the trace."""


def read(ctx):
    by_card, busy = ctx.trace.busy_by_card, ctx.trace.busy_s
    if not by_card or busy <= 0:
        return None
    rows, cols = ctx.config["mesh"]
    return 100.0 * sum(by_card.values()) / (rows * cols * busy)
