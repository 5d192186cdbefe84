"""Kernel (c) in groups of 2 and 4 queries (``csrc/packed_fractions.cu``):
the sum over its launches of the larger of the DB bytes at the memory peak
and the launch's int8 operations (31 rows a query) at the int8 peak
(``packed_fractions_bound_s`` of ``work/find_under.py``), over the kernel's
time a request."""

KERNELS = ("packed_fractions_kernel",)


def read(ctx):
    s = ctx.trace.device_seconds(lambda name: any(k in name for k in KERNELS))
    bound = ctx.work.get("packed_fractions_bound_s", 0.0)
    if s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (s / ctx.trace.requests)
