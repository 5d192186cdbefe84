"""The host blocked on the card (``iris.wait``): the bit-valued check's
event, each copy of a device result to the host, the compaction's
``nonzero``, each block of ``pipelined_stream``; its time a request, ms."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_request(ctx, "iris.wait", "total_s")
