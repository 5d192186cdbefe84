"""``pipelined_stream``'s dispatch (``iris.dispatch``): each chunk's
products launched and its copy to the host started; its self time a
request (all chunks), ms."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_request(ctx, "iris.dispatch")
