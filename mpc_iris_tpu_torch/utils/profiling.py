"""Profiling and tracing (counterpart of ``mpc_iris_tpu/utils/profiling.py``):
device traces from ``torch.profiler`` (CPU ops and, with a card, the CUDA
kernels, exported as a Chrome/Perfetto trace), the program's named spans and
counters, and device memory usage.

Spans and counters cost nothing but a flag check unless a ``torch.profiler``
capture runs in the process: the benchmark's ``--trace 1`` window, or a
CLI capture (``--profile-dir``, SIGUSR2). While one runs, a span is a
record-function event on the capture's timeline, on the clock of its CUDA
kernels and copies, and it also adds to an aggregate per name (count, total
seconds, self seconds: its time less that of the spans opened inside it on
its thread), which :func:`snapshot` reads. Set-up spans (``iris.setup.*``)
aggregate with no capture running too: they run once per engine.

Usage:
    with device_trace("/tmp/trace"):        # view with Perfetto / chrome://tracing
        engine.match(q, m)

    with annotate("iris.settle"): ...       # a span of the program
    count("iris.audit.overflows")           # a counter
    snapshot()["spans"]["iris.settle"]     # {"count", "total_s", "self_s"}
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _ExperimentalConfig, _RecordFunctionFast

SETUP = "iris.setup."

# The shared no-op that a span is while no capture runs.
NO_SPAN = contextlib.nullcontext()

_lock = threading.Lock()
_local = threading.local()
_spans: dict[str, list] = {}  # name -> [count, total seconds, self seconds]
_counters: dict[str, int] = {}
_requests = itertools.count(1)


def start_trace():
    """Start a ``torch.profiler`` capture of CPU ops and, when a card is
    present, its CUDA kernels; returns the running profiler. The CPU ops
    and spans of every thread are captured: a serving role computes on
    worker threads."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> str:
    """Stop ``prof`` and export its Chrome/Perfetto trace into ``log_dir``;
    returns the trace file's path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace context; writes ``log_dir/trace.json``."""
    prof = start_trace()
    try:
        yield log_dir
    finally:
        stop_trace(prof, log_dir)


class _Span:
    """One open span: while a capture runs, a record-function event of its
    name on the capture's timeline (torch's C++ ``RecordFunction``, the one
    ``record_function`` opens, without that wrapper's Python and its mirror
    on the device's timeline, which cost 11-16 us a span on an H100's host);
    and its time added to its name's aggregate when it closes."""

    __slots__ = ("name", "record", "t0", "inner")

    def __init__(self, name: str, record):
        self.name = name
        self.record = record

    def __enter__(self):
        if self.record is not None:
            self.record.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.inner = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter() - self.t0
        if self.record is not None:
            self.record.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].inner += t
        with _lock:
            agg = _spans.setdefault(self.name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += t
            agg[2] += t - self.inner
        return False


def annotate(name: str, *, request: bool = False):
    """A named span of the program: ``with annotate("iris.wait"): ...``.

    While no capture runs it is :data:`NO_SPAN` and touches nothing, except
    for the set-up spans (``iris.setup.*``), which aggregate always. A
    ``request`` span (the root of one engine call) carries a per-process
    request number as its argument ``request``, so that the spans of one
    request can be grouped: a capture that records inputs
    (``record_shapes=True``) on the span's thread exports it. A span must
    close on the thread that opened it, and never stay open across a
    ``yield``."""
    if _autograd_profiler._is_profiler_enabled:
        if request:
            return _Span(name, _RecordFunctionFast(name, [], {"request": next(_requests)}))
        return _Span(name, _RecordFunctionFast(name))
    if name.startswith(SETUP):
        return _Span(name, None)
    return NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter while a capture runs. ``n = 0`` makes the
    counter exist, so that a reader can tell none from not counted."""
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    """A copy of the aggregates: ``{"spans": {name: {"count", "total_s",
    "self_s"}}, "counters": {name: n}}``. They hold what ran while a capture
    ran, and every set-up span; their size is bounded by the names."""
    with _lock:
        return {"spans": {k: {"count": c, "total_s": t, "self_s": s}
                          for k, (c, t, s) in _spans.items()},
                "counters": dict(_counters)}


def device_memory_stats(device=None) -> dict:
    """Device memory of one card (bytes): in use by this process's tensors,
    the peak of that, and the card's total. ``None`` values on the CPU."""
    out = {"bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}
    if device is None:
        if not torch.cuda.is_available():
            return out
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return out
    try:
        stats = torch.cuda.memory_stats(device)
        _, total = torch.cuda.mem_get_info(device)
    except Exception:
        return out
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": total,
    }
