"""Kernel (b)'s int8 loop at B = 2-8 (``csrc/packed_match.cu``:
``packed_match_kernel`` and its partials' fold ``fold_parts_kernel``) on
every card: the sum over its launches of the larger of the card's DB bytes
at the memory peak and the launch's int8 operations (31 rows a query) at the
int8 peak (``packed_match_bound_s`` of ``work/sharded_match.py``), over
those kernels' time a request, summed over the cards."""

KERNELS = ("packed_match_kernel", "fold_parts_kernel")


def read(ctx):
    s = ctx.trace.device_seconds(lambda name: any(k in name for k in KERNELS))
    bound = ctx.work.get("packed_match_bound_s", 0.0)
    if s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (s / ctx.trace.requests)
