"""The reply's copy to the host (``pipelined_stream``'s device-to-host
copies): the reply's bytes (``reply_bytes`` a request; the profiler gives
no bytes for a copy) over the copies' time."""


def _copy(name: str) -> bool:
    return "Memcpy DtoH" in name


def read(ctx):
    s = ctx.trace.device_seconds(_copy)
    if s <= 0:
        return None
    return ctx.work["reply_bytes"] * ctx.trace.requests / s / 1e9
