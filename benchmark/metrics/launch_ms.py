"""The host's launch (``iris.launch``) in the cells of several queries a
request: the packed dispatchers' argument checks, buffer allocation and
kernel launches, less the query prep and waits inside them; on a mesh one
host thread launches every shard in turn. Its self time a request, ms."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_request(ctx, "iris.launch")
