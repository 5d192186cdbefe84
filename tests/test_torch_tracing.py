"""The port's spans and counters (``utils/profiling.py``: ``annotate``,
``count``, ``snapshot``) on the CPU: off, they are one shared no-op and
record nothing; under ``torch.profiler`` each span lands on the timeline and
in its name's aggregate; self time and the thread-local stacks; and the
spans and the overflow counter that the engines' requests and
``pipelined_stream`` open. The aggregates are process-wide, so each test
reads what its own calls added."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from mpc_iris_tpu_torch.models.engines import KeyedShareEngine, PlaintextEngine, pipelined_stream
from mpc_iris_tpu_torch.ops import self_test
from mpc_iris_tpu_torch.ops.packed_match import planted_packed_case
from mpc_iris_tpu_torch.utils import profiling

ROOT_CHILDREN = 0.8  # the least share of a root's time its child spans cover


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _tracing() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def _capture(**kw):
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **kw)


class _Added:
    """What the calls inside the block added to the aggregates."""

    def __enter__(self):
        self.before = profiling.snapshot()
        return self

    def __exit__(self, *exc):
        after = profiling.snapshot()
        zero = {"count": 0, "total_s": 0.0, "self_s": 0.0}
        self.spans = {name: {k: v - self.before["spans"].get(name, zero)[k] for k, v in s.items()}
                      for name, s in after["spans"].items()}
        self.spans = {n: s for n, s in self.spans.items() if s["count"]}
        self.counters = {n: v - self.before["counters"].get(n, 0)
                         for n, v in after["counters"].items()}
        return False


@pytest.fixture(scope="module")
def engine():
    pat, msk, qpat, qmsk = planted_packed_case(np.random.default_rng(18), n=700, b=3)
    return PlaintextEngine(pat, msk, device="cpu", chunk=256), qpat, qmsk


def test_off_is_one_shared_noop_that_records_nothing(engine):
    eng, qpat, qmsk = engine
    assert not _tracing()
    assert profiling.annotate("iris.wait") is profiling.NO_SPAN
    assert profiling.annotate("iris.match", request=True) is profiling.NO_SPAN
    before = profiling.snapshot()
    with profiling.annotate("iris.test.off"):
        profiling.count("iris.test.off")
    eng.match(qpat[:1], qmsk[:1])
    eng.find_under(qpat, qmsk, 0.45, compact_k=4)
    assert profiling.snapshot() == before


def test_setup_spans_aggregate_without_a_capture(monkeypatch):
    assert not _tracing()
    monkeypatch.setattr(self_test, "_self_tested", set())
    pat, msk, _, _ = planted_packed_case(np.random.default_rng(1), n=300, b=1)
    with _Added() as added:
        PlaintextEngine(pat, msk, device="cpu", chunk=128)
    assert {n: s["count"] for n, s in added.spans.items()} == {
        "iris.setup.kernel_self_test": 1, "iris.setup.db_load": 1}
    assert all(s["self_s"] > 0 for s in added.spans.values())


def test_a_span_lands_on_the_timeline_with_its_time(tmp_path):
    """Each span is one event of the exported trace, as long as its
    aggregate within 50 us: the median of nine 0.2 ms spans, after one to
    warm the profiler up (the event also holds the profiler's own entry and
    exit, and the profiler's clock drifts from the host's by up to a few
    percent on a shared host, so the spans are short)."""
    names = [f"iris.test.on{i}" for i in range(10)]
    with _Added() as added, _capture() as prof:
        assert _tracing()
        for name in names:
            with profiling.annotate(name):
                t = time.perf_counter()
                while time.perf_counter() - t < 0.0002:
                    pass
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("name", "").startswith("iris.test.on")]
    assert sorted(e["name"] for e in events) == sorted(names)
    assert all(added.spans[n]["count"] == 1 for n in names)
    gaps = sorted(abs(e["dur"] - 1e6 * added.spans[e["name"]]["total_s"])
                  for e in events if e["name"] != names[0])
    assert gaps[4] < 50, gaps


def test_root_spans_carry_a_request_number(engine, tmp_path):
    eng, qpat, qmsk = engine
    with _capture(record_shapes=True) as prof:
        for b in (1, 2):
            eng.match(qpat[:b], qmsk[:b])
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    numbers = [e["args"]["request"] for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"] if e.get("name") == "iris.match"]
    assert len(numbers) == 2 and numbers[1] == numbers[0] + 1


def test_self_time_leaves_out_the_spans_inside():
    with _Added() as added, _capture():
        with profiling.annotate("iris.test.outer"):
            time.sleep(0.002)
            for _ in range(2):
                with profiling.annotate("iris.test.inner"):
                    time.sleep(0.001)
    outer, inner = added.spans["iris.test.outer"], added.spans["iris.test.inner"]
    assert (outer["count"], inner["count"]) == (1, 2)
    assert inner["self_s"] == inner["total_s"] >= 0.002
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    assert outer["self_s"] >= 0.002


def test_each_thread_nests_its_own_spans():
    """Two threads hold their outer spans open at once and open their inner
    ones in between: each inner span counts against its own thread's outer
    span only."""
    step = threading.Barrier(2)

    def work():
        with profiling.annotate("iris.test.t_outer"):
            step.wait()
            with profiling.annotate("iris.test.t_inner"):
                step.wait()
                time.sleep(0.002)
            step.wait()

    with _Added() as added, _capture():
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    outer, inner = added.spans["iris.test.t_outer"], added.spans["iris.test.t_inner"]
    assert (outer["count"], inner["count"]) == (2, 2)
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    assert 0 <= outer["self_s"] < outer["total_s"]


def test_a_cli_capture_holds_the_spans_of_every_thread(tmp_path):
    """``device_trace`` (the CLI's captures) records a span that a worker
    thread opens, as a serving role's pump thread does."""
    def work():
        with profiling.annotate("iris.test.worker"):
            torch.ones(4).sum()

    with profiling.device_trace(str(tmp_path)):
        t = threading.Thread(target=work)
        t.start()
        t.join()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "iris.test.worker" for e in events)


def test_a_counter_counts_only_under_a_capture():
    with _Added() as added:
        profiling.count("iris.test.c", 5)
        with _capture():
            profiling.count("iris.test.c")
            profiling.count("iris.test.c", 2)
            profiling.count("iris.test.zero", 0)
    assert added.counters["iris.test.c"] == 3
    assert added.counters["iris.test.zero"] == 0


def _covered(span) -> float:
    return 1 - span["self_s"] / span["total_s"]


@pytest.mark.parametrize("b", [1, 3])
def test_match_requests_are_covered_by_their_spans(engine, b):
    eng, qpat, qmsk = engine
    with _Added() as added, _capture():
        for _ in range(2):
            eng.match(qpat[:b], qmsk[:b])
    root = added.spans["iris.match"]
    assert root["count"] == 2 and _covered(root) >= ROOT_CHILDREN
    assert {"iris.query_prep", "iris.launch", "iris.wait", "iris.settle"} <= set(added.spans)


@pytest.mark.parametrize("compact_k,overflows", [(4, 2), (512, 0)], ids=["overflow", "compacted"])
def test_find_under_counts_each_overflow(engine, compact_k, overflows):
    """Threshold 0.45 gives every query more candidates than 4: each request
    overflows once into the full spectrum; with room for all, none does."""
    eng, qpat, qmsk = engine
    with _Added() as added, _capture():
        for _ in range(2):
            eng.find_under(qpat, qmsk, 0.45, compact_k=compact_k)
    root = added.spans["iris.find_under"]
    assert root["count"] == 2 and _covered(root) >= ROOT_CHILDREN
    assert added.counters["iris.audit.overflows"] == overflows
    assert {"iris.query_prep", "iris.launch", "iris.compact", "iris.wait",
            "iris.settle"} <= set(added.spans)


def test_stream_spans_each_chunk_and_holds_none_across_a_yield():
    eng = KeyedShareEngine(bytes(range(32)), 0, 600, device="cpu", chunk=256)
    qpat, qmsk = planted_packed_case(np.random.default_rng(2), n=300, b=2)[2:]
    open_at_yield = []
    with _Added() as added, _capture():
        for _ in eng.stream(qpat, qmsk, entry_major=True):
            open_at_yield.append(len(getattr(profiling._local, "stack", [])))
    assert open_at_yield == [0] * eng.num_chunks() == [0, 0, 0]
    assert {n: s["count"] for n, s in added.spans.items()} == {
        "iris.query_prep": 1, "iris.dispatch": 3, "iris.wait": 3}


def test_pipelined_stream_spans_one_dispatch_and_one_wait_a_chunk():
    blocks = []

    def dispatch(c):
        blocks.append(c)
        return torch.full((2, 5, 31), c, dtype=torch.int16)

    with _Added() as added, _capture():
        got = list(pipelined_stream(dispatch, 7, 33, 5))
    assert blocks == list(range(7)) and [int(g[0, 0, 0]) for g in got] == blocks
    assert {n: s["count"] for n, s in added.spans.items()} == {"iris.dispatch": 7, "iris.wait": 7}
