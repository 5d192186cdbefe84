"""Kernel (b) at B = 1 (``csrc/b1_packed.cu``: ``pk_select_kernel`` and its
fold ``fold_parts_kernel``): the packed DB read once at the memory peak,
over those kernels' time a request."""

from benchmark.peaks import HBM_BYTES_PER_S

KERNELS = ("pk_select_kernel", "fold_parts_kernel")


def read(ctx):
    s = ctx.trace.device_seconds(lambda name: any(k in name for k in KERNELS))
    if s <= 0:
        return None
    return 100.0 * ctx.work["db_bytes"] / HBM_BYTES_PER_S / (s / ctx.trace.requests)
