"""The scan's products (e): the numerator-dot and denominator products of
every chunk, both in one ``packed_gemm_kernel`` launch over the packed chunk
(``ops/scan.py::_packed_gemm_products`` -> ``ops/packed_gemm.py`` ->
``csrc/packed_gemm.cu``), whose least time is their int8 operations (31 rows
a query) at the int8 peak, over the GEMM kernels' time a request."""

from benchmark.peaks import INT8_OPS

GEMM = ("gemm", "xmma", "cutlass")


def read(ctx):
    s = ctx.trace.device_seconds(lambda name: any(k in name.lower() for k in GEMM))
    if s <= 0:
        return None
    return 100.0 * ctx.work["int8_ops"] / INT8_OPS / (s / ctx.trace.requests)
