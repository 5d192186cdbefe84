"""The program's own spans and counters (``mpc_iris_tpu_torch.utils.profiling``:
``annotate``, ``count``, ``snapshot``), as the per-layer readers take them.

The aggregates hold what ran while the window's profiler ran, and every
set-up span (``iris.setup.*``) of the process: the warm-up runs before the
profiler starts. A program without a span or counter, or without the
snapshot at all, gives ``None``, never 0.
"""

from __future__ import annotations


def _snapshot() -> dict | None:
    try:
        from mpc_iris_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    return snapshot()


def seconds(name: str, field: str = "self_s") -> float | None:
    """A span's seconds in all: ``self_s`` (less its inner spans) or
    ``total_s``."""
    snap = _snapshot()
    span = snap["spans"].get(name) if snap else None
    return None if span is None else span[field]


def ms_a_request(ctx, name: str, field: str = "self_s") -> float | None:
    s = seconds(name, field)
    return None if s is None else 1e3 * s / ctx.trace.requests


def counted(name: str) -> int | None:
    snap = _snapshot()
    return snap["counters"].get(name) if snap else None
