"""The request's device work against its least time: the bytes a request
needs (``request_bytes`` of the entry's work function: the DB read once,
and the reply written once where the reply is the output) at the memory
peak, over the device's busy time a request. No operations are counted: no
published peak bounds the binary tensor-core path some kernels take."""

from benchmark.peaks import HBM_BYTES_PER_S


def read(ctx):
    busy = ctx.trace.busy_s / ctx.trace.requests
    return 100.0 * ctx.work["request_bytes"] / HBM_BYTES_PER_S / busy if busy > 0 else None
