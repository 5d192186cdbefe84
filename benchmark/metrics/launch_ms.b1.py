"""The host's launch (``iris.launch``): the packed dispatchers' argument
checks, buffer allocation and kernel launches, less the query prep and
waits inside them; its self time a request, ms."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_request(ctx, "iris.launch")
