"""The share dots (f): the two int8 products of every chunk
(``torch._int_mm`` through ``ops/dot.py::dot_share_batch``). Their least
time is the larger of the share planes read once at the memory peak and
their int8 operations (31 rows a query) at the int8 peak, over the int8
GEMM kernels' time a request."""

from benchmark.peaks import HBM_BYTES_PER_S, INT8_OPS

GEMM = ("gemm", "xmma", "cutlass")


def read(ctx):
    s = ctx.trace.device_seconds(lambda name: any(k in name.lower() for k in GEMM))
    if s <= 0:
        return None
    bound = max(ctx.work["share_bytes"] / HBM_BYTES_PER_S, ctx.work["int8_ops"] / INT8_OPS)
    return 100.0 * bound / (s / ctx.trace.requests)
