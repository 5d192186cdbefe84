"""The audit's host settle (``iris.settle``): the exact compare of the
compacted candidates, or on an overflow of the whole spectrum; its self
time a request, ms."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_request(ctx, "iris.settle")
