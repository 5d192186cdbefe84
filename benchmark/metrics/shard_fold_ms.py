"""The sharded engine's fold across cards (``iris.fold``): each shard's
winners' local indices made global, gathered on the first card and folded by
the exact fraction minimum (``collectives.fraction_allmin``); its self time
a request, ms."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_request(ctx, "iris.fold")
