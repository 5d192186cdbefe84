"""Requests whose candidates overflowed the compact buffer into the full
spectrum (the counter ``iris.audit.overflows``), per 100 requests."""

from benchmark import spans


def read(ctx):
    n = spans.counted("iris.audit.overflows")
    return None if n is None else 100.0 * n / ctx.trace.requests
