"""The traced window: ``torch.profiler`` over the closed loop, reduced to what
the per-layer readers and the breakdown take.

Every request runs inside a ``request`` span of the harness's own. The
window is the first request's start to the last one's end; the device is busy
where any device operation (kernel, copy, set) runs on any card, merged over
overlaps, and each card is busy where its own operations run.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

SPAN = "request"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    requests: int
    device_ops: list[tuple[str, int, int]]  # name, start ns, duration ns
    gaps: list[tuple[str, float]] = field(default_factory=list)  # host op under a gap, s
    busy_by_card: dict[int, float] = field(default_factory=dict)  # card -> s busy

    def device_seconds(self, match) -> float:
        """Seconds of the device operations whose name ``match`` accepts."""
        return sum(d for name, _, d in self.device_ops if match(name)) / 1e9

    @property
    def idle_pct(self) -> float:
        return 100.0 * (self.window_s - self.busy_s) / self.window_s

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(float)
        for name, _, d in self.device_ops:
            ops[name] += d / 1e9
        gaps = defaultdict(float)
        for name, s in self.gaps:
            gaps[name] += s
        return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top]}


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, record_shapes=False, with_stack=False,
                   profile_memory=False)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof) -> Trace:
    """The profiler's events -> :class:`Trace`."""
    from torch.autograd import DeviceType

    host, device, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.name() == SPAN:
                spans.append((start, start + dur))
            host.append((start, start + dur, e.name()))
        elif e.name() != SPAN and not getattr(e, "is_user_annotation", lambda: False)():
            # the profiler mirrors each host span on the device's timeline;
            # those are not device work
            device.append((e.name(), e.device_index(), start, dur))
    return from_events(spans, host, device)


def from_events(spans, host, device) -> Trace:
    """The window's arithmetic, in ns: ``spans`` the harness's requests as
    (start, end), ``host`` the host's events as (start, end, name),
    ``device`` the device operations as (name, card, start, duration)."""
    if not spans:
        raise RuntimeError("the traced window holds no request")
    w0 = min(s for s, _ in spans)
    w1 = max(e for _, e in spans)
    ops = [op for op in device if op[2] < w1 and op[2] + op[3] > w0]
    by_card = defaultdict(list)
    for _, card, s, d in ops:
        by_card[card].append((max(s, w0), min(s + d, w1)))
    merged = {card: _merge(iv) for card, iv in sorted(by_card.items())}
    busy = _merge(iv for card in merged.values() for iv in card)
    return Trace((w1 - w0) / 1e9, _seconds(busy), len(spans),
                 [(name, s, d) for name, _, s, d in ops],
                 _label_gaps(busy, w0, w1, host),
                 {card: _seconds(iv) for card, iv in merged.items()})


def _seconds(merged) -> float:
    return sum(e - s for s, e in merged) / 1e9


def _label_gaps(busy, w0: int, w1: int, host) -> list[tuple[str, float]]:
    """Each idle gap of the device in [w0, w1] with what the host was doing:
    the innermost host event (the latest started) that covers the gap's
    midpoint. One sweep: events are pushed in order of start; one that has
    ended by a midpoint is done for every later one."""
    host.sort()
    out, stack, k, t = [], [], 0, w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            mid = (s + t) // 2
            while k < len(host) and host[k][0] <= mid:
                stack.append(host[k])
                k += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            out.append((stack[-1][2] if stack else "idle host", (s - t) / 1e9))
        t = max(t, e)
    return out
