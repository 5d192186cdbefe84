"""Tiny runs of every cell on the CPU: the port judged by the reference comes
out correct; the control (the reference in a lower precision in the
program's place) and the program broken underneath come out not correct."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark import manifest as mf
from mpc_iris_tpu_torch.models import engines

M = mf.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
# Small sizes: three engine chunks, a few distinct requests; the copies
# dense enough that every sample holds some.
SMALL = {"config": {"entries": 700, "chunk": 256},
         "traffic": {"distinct_requests": 3, "warmup_requests": 1, "check_queries": 8,
                     "duplicate_share": 0.5, "control_requests": 4, "check_stride": 256}}


def _small(workload: str) -> dict:
    traffic = mf.traffic(mf.cell(M, workload)["traffic"])
    extra = {"batch": 16} if traffic["batch"] > 16 else {}
    if traffic["entry"] == "keyed_stream":
        extra["duplicate_share"] = 0
    if "db_clusters" in traffic:  # the largest cluster overflows the compact buffer
        extra.update(db_clusters=[[2, 3], [1, 40]], db_flip_bits=8, compact_k=16)
    return {"config": dict(SMALL["config"]), "traffic": {**SMALL["traffic"], **extra}}


def _run(workload: str, seconds: float = 0.3, **kw) -> harness.Run:
    return harness.run_cell(workload, 2**31 + 11, seconds, False, "cpu", time.perf_counter(),
                            overrides=_small(workload), **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_is_correct(workload):
    run = _run(workload)
    assert run.correct, run.checks
    assert run.attempted >= 1 and run.failed == 0
    assert {"setup_s", "request_p50_ms", "comparisons_per_s"} <= {
        mf.quantity(name) for name in run.metrics}


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    run = control.control_run(workload, 77, "cpu", overrides=_small(workload))
    assert not run.correct, run.checks


def _entry(workload: str) -> str:
    return mf.traffic(mf.cell(M, workload)["traffic"])["entry"]


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_program_is_not_correct(workload, fault, monkeypatch):
    """Each fault of the cell's entry (``faults/<entry>.py``) planted in the
    port: the run is not correct."""
    getattr(mf.faults(_entry(workload)), fault)(monkeypatch)
    run = _run(workload)
    assert not run.correct, run.checks


def test_a_failing_request_is_not_correct(monkeypatch):
    orig = engines.PlaintextEngine.match_arrays
    calls = []

    def boom(self, *a):
        calls.append(1)
        if len(calls) > 1:  # after the warm-up request
            raise RuntimeError("planted")
        return orig(self, *a)
    monkeypatch.setattr(engines.PlaintextEngine, "match_arrays", boom)
    run = _run(CELLS[0])
    assert not run.correct and run.failed == run.attempted >= 1
    assert run.checks["unanswered"]["value"] == run.failed


def test_the_trace_reduces_to_the_readers():
    """A CPU trace has no device ops: the idle share is 100%, every other
    device reader gives nothing (never 0), and the program's spans give
    the cell's span metrics."""
    run = harness.run_cell(CELLS[0], 3, 0.3, True, "cpu", time.perf_counter(),
                           overrides=_small(CELLS[0]))
    assert run.correct
    assert set(run.metrics) == {"device_idle_pct.b1", "query_prep_ms.b1", "launch_ms.b1",
                                "host_wait_ms.b1", "kernel_self_test_s", "db_load_s"}
    # 100 (w - 0) / w is 100 up to the last bit of rounding
    assert run.metrics["device_idle_pct.b1"] == {"value": pytest.approx(100.0, rel=1e-12),
                                                 "unit": "%"}
    others = {m["name"] for m in mf.per_layer(M, CELLS[0])
              if m["source"] == "device_trace"} - {"device_idle_pct.b1"}
    assert others and not others & set(run.metrics)
    assert run.trace.requests == run.attempted and run.trace.busy_s == 0
    assert run.trace.busy_by_card == {}


def test_same_seed_same_inputs():
    from benchmark import data

    t = {**mf.traffic("audit-b8"), "distinct_requests": 2}
    db1 = data.make_db(50, 9, "cpu")
    db2 = data.make_db(50, 9, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(db1, db2))
    p1, p2 = data.make_pool(t, 2**33, db1), data.make_pool(t, 2**33, db2)
    assert np.array_equal(p1.pat, p2.pat) and np.array_equal(p1.source, p2.source)
    assert not np.array_equal(data.make_db(50, 10, "cpu")[0], db1[0])
    # every seed the same number of copies of enrolled entries
    counts = {int((data.make_pool(t, s, db1).source >= 0).sum()) for s in range(5)}
    assert counts == {round(t["duplicate_share"] * 2 * t["batch"])}
    assert torch.equal(data.device_planes(4, 1, "x", "cpu"), data.device_planes(4, 1, "x", "cpu"))


def test_the_audit_judges_clusters_and_the_overflow(monkeypatch):
    """The audit's planted clusters give lists of many entries, and the
    largest overflows the compact buffer into the full spectrum; both are
    judged."""
    workload = next(w for w in CELLS if _entry(w) == "find_under")
    full = []
    orig = engines.PlaintextEngine._host_spectrum
    monkeypatch.setattr(engines.PlaintextEngine, "_host_spectrum",
                        lambda self, nd: full.append(1) or orig(self, nd))
    run = _run(workload, max_requests=3)  # the whole pool
    assert run.correct, run.checks
    assert full, "no request took the overflow path"


def test_the_sample_covers_every_slot():
    from benchmark import data, plaintext_db

    b, p = 16, 4
    pool = data.Pool(np.zeros((p, b, 1), np.uint8), np.zeros((p, b, 1), np.uint8),
                     np.where(np.arange(p * b).reshape(p, b) % 5 == 0, 7, -1))
    inputs = plaintext_db.Inputs(None, None, pool, data.plan_clusters({}, 10, 1))
    traffic = {"batch": b, "check_queries": b}
    picks = plaintext_db.sample(traffic, inputs, range(3 * p), 2**33)
    assert len(picks) == b and {q for _, q in picks} == set(range(b))
    assert sum(pool.source[i % p, q] >= 0 for i, q in picks) == b // 2
