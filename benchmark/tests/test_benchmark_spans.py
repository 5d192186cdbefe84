"""The readers of the program's spans and counters (``benchmark/spans.py``):
their arithmetic on a fixed snapshot, nothing where the program has no such
span, counter or snapshot, and a number in a traced CPU run of every cell."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import harness, spans
from benchmark import manifest as mf
from benchmark.tests.test_benchmark_runs import _small

M = mf.load_manifest()
SOURCES = ("program_span", "program_counter")
READERS = [m["name"] for m in M["per_layer"] if m["source"] in SOURCES]
SNAPSHOT = {
    "spans": {
        "iris.query_prep": {"count": 8, "total_s": 0.010, "self_s": 0.008},
        "iris.launch": {"count": 4, "total_s": 0.012, "self_s": 0.002},
        "iris.wait": {"count": 8, "total_s": 0.020, "self_s": 0.020},
        "iris.dispatch": {"count": 248, "total_s": 0.030, "self_s": 0.030},
        "iris.settle": {"count": 4, "total_s": 0.004, "self_s": 0.003},
        "iris.setup.kernel_self_test": {"count": 1, "total_s": 10.5, "self_s": 0.5},
        "iris.setup.db_load": {"count": 1, "total_s": 2.0, "self_s": 2.0},
    },
    "counters": {"iris.audit.overflows": 1},
}


def _ctx(requests: int = 4):
    return SimpleNamespace(trace=SimpleNamespace(requests=requests), work={}, config={},
                           traffic={})


def test_the_readers_of_a_snapshot(monkeypatch):
    monkeypatch.setattr(spans, "_snapshot", lambda: SNAPSHOT)
    read = {name: mf.metric_reader(name).read(_ctx()) for name in READERS}
    assert read == pytest.approx({
        "query_prep_ms.b1": 2.0, "query_prep_ms": 2.0, "launch_ms.b1": 0.5,
        "host_wait_ms.b1": 5.0, "host_wait_ms": 5.0, "stream_dispatch_ms": 7.5,
        "audit_settle_ms": 0.75, "audit_overflow_pct": 25.0,
        "kernel_self_test_s": 0.5, "db_load_s": 2.0})


@pytest.mark.parametrize("snapshot", [None, {"spans": {}, "counters": {}}],
                         ids=["no_snapshot", "nothing_recorded"])
def test_the_readers_give_nothing_without_their_span(monkeypatch, snapshot):
    monkeypatch.setattr(spans, "_snapshot", lambda: snapshot)
    assert {name: mf.metric_reader(name).read(_ctx()) for name in READERS} == dict.fromkeys(
        READERS)


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_a_traced_cpu_run_reads_every_span_metric(workload):
    run = harness.run_cell(workload, 2**31 + 29, 0.3, True, "cpu", time.perf_counter(),
                           overrides=_small(workload), max_requests=3)  # the whole pool
    assert run.correct, run.checks
    want = {m["name"] for m in mf.per_layer(M, workload) if m["source"] in SOURCES}
    got = {name: v["value"] for name, v in run.metrics.items() if name in want}
    assert set(got) == want and all(v >= 0 for v in got.values()), got
    if "audit_overflow_pct" in want:  # the small audit's largest cluster overflows
        assert got["audit_overflow_pct"] > 0
