"""The scan's products (e): the numerator-dot and denominator products of
every chunk (``ops/scan.py::_chunk_products`` -> ``torch._int_mm``), whose
least time is their int8 operations (31 rows a query) at the int8 peak,
over the int8 GEMM kernels' time a request."""

from benchmark.peaks import INT8_OPS

GEMM = ("gemm", "xmma", "cutlass")


def read(ctx):
    s = ctx.trace.device_seconds(lambda name: any(k in name.lower() for k in GEMM))
    if s <= 0:
        return None
    return 100.0 * ctx.work["int8_ops"] / INT8_OPS / (s / ctx.trace.requests)
