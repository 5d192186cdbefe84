"""Progress/throughput reporting to stderr (copy of
``mpc_iris_tpu/utils/progress.py``; the reference uses indicatif bars with
bytes/sec and items/sec templates, src/main.rs:178-183)."""

from __future__ import annotations

import sys
import time


def _human(n: float, unit: str) -> str:
    for prefix, scale in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if n >= scale:
            return f"{n / scale:.2f} {prefix}{unit}"
    return f"{n:.0f} {unit}"


class Progress:
    """Minimal rate meter: count and bytes per second, periodic stderr updates."""

    def __init__(self, label: str, total: int | None = None, unit: str = "items",
                 interval: float = 1.0, stream=None):
        self.label = label
        self.total = total
        self.unit = unit
        self.interval = interval
        self.count = 0
        self.bytes = 0
        self.start = time.monotonic()
        self._last = self.start
        self.stream = stream if stream is not None else sys.stderr

    def update(self, count: int = 0, nbytes: int = 0) -> None:
        self.count += count
        self.bytes += nbytes
        now = time.monotonic()
        if now - self._last >= self.interval:
            self._last = now
            self._emit(now)

    def _emit(self, now: float) -> None:
        dt = max(now - self.start, 1e-9)
        parts = [f"{self.label}:", f"{self.count}"]
        if self.total:
            parts.append(f"/{self.total}")
        parts.append(f"({_human(self.count / dt, self.unit + '/s')})")
        if self.bytes:
            parts.append(f"{_human(self.bytes / dt, 'B/s')}")
        parts.append(f"{dt:.1f}s")
        print(" ".join(parts), file=self.stream, flush=True)

    def finish(self) -> None:
        self._emit(time.monotonic())
