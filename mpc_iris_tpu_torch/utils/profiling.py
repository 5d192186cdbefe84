"""Profiling and tracing (counterpart of ``mpc_iris_tpu/utils/profiling.py``):
device traces from ``torch.profiler`` (CPU ops and, with a card, the CUDA
kernels, exported as a Chrome/Perfetto trace), named regions, device memory
usage, and host-side stage timers (``StageTimers`` is a copy).

Usage:
    with device_trace("/tmp/trace"):        # view with Perfetto / chrome://tracing
        engine.match(q, m)

    timers = StageTimers()
    with timers.stage("encode"): ...
    print(timers.report())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


def start_trace():
    """Start a ``torch.profiler`` capture of CPU ops and, when a card is
    present, its CUDA kernels; returns the running profiler."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
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


def annotate(name: str):
    """Named region on the trace's timeline (``record_function``)."""
    import torch

    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> dict:
    """Device memory of one card (bytes): in use by this process's tensors,
    the peak of that, and the card's total. ``None`` values on the CPU."""
    import torch

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


class StageTimers:
    """Accumulating named stage timers for host-side pipeline stages
    (== the reference's indicatif per-stage bars, src/main.rs:178-183)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.totals[name] += time.monotonic() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values()) or 1e-9
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:24s} {t:9.3f}s  {100 * t / total:5.1f}%  "
                f"x{self.counts[name]}"
            )
        return "\n".join(lines)
