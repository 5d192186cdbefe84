"""One run of one cell: inputs from the seed, set-up, a closed loop for the
window, the check against the plain reference, and the result's numbers.

Shared by every cell; what differs between cells comes from the files the
cell names (see manifest.py). Nothing here branches on a cell's name.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import manifest as mf
from benchmark import trace as tr


@dataclass
class Request:
    index: int
    start: float
    end: float
    answer: object = None
    error: str | None = None


@dataclass
class Context:
    """What a per-layer reader reads."""

    trace: tr.Trace
    work: dict
    config: dict
    traffic: dict


@dataclass
class Run:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    checks: dict
    setup_s: float
    memory_peak_bytes: int
    trace: tr.Trace | None = None
    errors: list[str] = field(default_factory=list)
    notes: list[str] = field(default_factory=list)


def cards(device, chips: int) -> list[torch.device]:
    """The cards of a cell of ``chips`` cards: ``cuda:0`` up to
    ``cuda:<chips - 1>``; on the CPU, the one device."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(chips)]


def sync(used: list[torch.device]) -> None:
    for card in used:
        if card.type == "cuda":
            torch.cuda.synchronize(card)


def memory_peaks(used: list[torch.device]) -> dict[str, int]:
    """Each card's peak of allocated device memory (0 on the CPU)."""
    return {str(c): torch.cuda.max_memory_allocated(c) if c.type == "cuda" else 0 for c in used}


def closed_loop(served, seconds: float, max_requests: int | None, span: bool) -> list[Request]:
    """One caller: the next request goes out when the last one has come
    back, until ``seconds`` have passed (or ``max_requests`` are done)."""
    done = []
    deadline = time.perf_counter() + seconds
    i = 0
    while True:
        start = time.perf_counter()
        if (i >= max_requests) if max_requests is not None else (start >= deadline):
            break
        try:
            if span:
                with torch.profiler.record_function(tr.SPAN):
                    answer = served(i)
            else:
                answer = served(i)
            done.append(Request(i, start, time.perf_counter(), answer))
        except Exception as exc:  # a failed request counts, the loop goes on
            done.append(Request(i, start, time.perf_counter(), error=repr(exc)))
        i += 1
    return done


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t0: float, *,
             overrides: dict | None = None, control: bool = False,
             max_requests: int | None = None, manifest: dict | None = None) -> Run:
    """Run ``workload`` once. ``t0``: the process's start on the
    ``perf_counter`` clock. ``overrides``: keys replaced in the cell's
    ``config`` and ``traffic`` (the CPU tests' small sizes). ``control``: the
    entry's control (the reference in a lower precision) answers in the
    program's place."""
    manifest = manifest or mf.load_manifest()
    cell = mf.cell(manifest, workload)
    overrides = overrides or {}
    config = {**mf.config(cell["config"]), **overrides.get("config", {})}
    traffic = {**mf.traffic(cell["traffic"]), **overrides.get("traffic", {})}
    entry = mf.entry(traffic["entry"])
    work = mf.work(traffic["entry"]).work(config, traffic)
    used = cards(device, int(cell["chips"]))

    phases = [("imports", time.perf_counter())]
    inputs = entry.prepare(config, traffic, seed, device)
    sync(used)
    phases.append(("inputs", time.perf_counter()))
    served = (entry.control if control else entry.build)(config, traffic, inputs, device)
    sync(used)
    phases.append(("build", time.perf_counter()))
    for i in range(0 if control else int(traffic["warmup_requests"])):
        served(i)
    sync(used)
    phases.append(("warm-up", time.perf_counter()))
    setup_s = phases[-1][1] - t0

    prof = tr.profiler() if trace else contextlib.nullcontext()
    with prof:
        done = closed_loop(served, seconds, max_requests, span=trace)
        sync(used)
    peaks = memory_peaks(used)
    del served
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    starts = [t0] + [t for _, t in phases]
    notes = ["set-up: " + ", ".join(f"{name} {t - s:.3f} s"
                                    for (name, t), s in zip(phases, starts)),
             "peak device memory by card: " + ", ".join(f"{c} {b} bytes" for c, b in peaks.items())]
    reduced = None
    if trace:
        t = time.perf_counter()
        reduced = tr.reduce(prof)
        notes.append(f"trace: {len(reduced.device_ops)} device ops in {reduced.requests} "
                     f"requests, reduced in {time.perf_counter() - t:.1f} s")
        notes.append(f"busy by card (of {reduced.window_s!r} s): " + ", ".join(
            f"{card} {s!r} s" for card, s in reduced.busy_by_card.items()))

    ok = [r for r in done if r.error is None]
    t_judge = time.perf_counter()
    checks = entry.judge(config, traffic, inputs, {r.index: r.answer for r in ok},
                         len(done) - len(ok), seed, device)
    correct = bool(ok) and all(c["value"] <= c["limit"] for c in checks.values())
    notes.append(f"{len(done)} requests in the window, judged in "
                 f"{time.perf_counter() - t_judge:.1f} s")

    if trace:
        ctx = Context(reduced, work, config, traffic)
        metrics = {}
        for m in mf.per_layer(manifest, workload):
            value = mf.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        lat = [r.end - r.start for r in ok]
        window = max(r.end for r in done) - min(r.start for r in done)
        e2e = {
            "setup_s": setup_s,
            "request_p50_ms": 1e3 * statistics.median(lat) if lat else None,
            "request_p95_ms": 1e3 * float(np.percentile(lat, 95)) if lat else None,
            "comparisons_per_s": len(ok) * work["comparisons"] / window,
        }
        # A quantity may be split into metrics of its own for some cells,
        # named by a suffix (``request_p50_ms.b1``): the same quantity.
        metrics = {m["name"]: {"value": e2e[mf.quantity(m["name"])], "unit": m["unit"]}
                   for m in mf.end_to_end(manifest, workload)
                   if e2e.get(mf.quantity(m["name"])) is not None}
    return Run(correct, len(done), len(done) - len(ok), metrics, checks, setup_s,
               max(peaks.values()),
               reduced, [r.error for r in done if r.error][:5], notes)
