"""The port's ``ShardedPlaintextEngine`` on four shards of the one CPU device
against the benchmark's plain reference (``benchmark/reference/plaintext.py``:
torch and numpy, nothing of the port), exact: winners as (index, n, d, f64).
Also its chunk-by-chunk build against the layout of the whole local slab it
replaced, its spans and counter under a capture, the shared host-spectrum
copy, and the benchmark's sharded work function and readers."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark import trace as tr
from benchmark.reference import plaintext as ref
from benchmark.work import sharded_match as work
from mpc_iris_tpu_torch.models.engines import host_spectrum
from mpc_iris_tpu_torch.parallel import ShardedPlaintextEngine, make_mesh
from mpc_iris_tpu_torch.parallel.mesh import Mesh
from mpc_iris_tpu_torch.parallel.sharded import _local_chunk_iter, local_db_span
from mpc_iris_tpu_torch.utils import profiling

CPU = torch.device("cpu")
CHUNK = 32


def cpu_mesh(db, batch=1):
    return make_mesh(db, batch, devices=[CPU] * (db * batch))


def shard_of(e: int, chunk: int = CHUNK, shards: int = 4) -> int:
    return (e // chunk) % shards


def planted_db(n: int, seed: int):
    """A random packed DB of ``n`` entries with two clusters of exact copies
    spread over the shards (chunk 32, four shards): entry 100 (shard 3)
    copied to 150, 170, 200 (shards 0, 1, 2) and into the last chunk; entry
    260 (shard 0) copied to the entry after it in the next chunk. Returns
    the planes and the clusters' sources."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, 256, (n, data.BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, data.BITS_BYTES), dtype=np.uint8)
    for src, copies in ((100, (150, 170, 200, n - 3)), (260, (n - 1,))):
        pat[list(copies)], msk[list(copies)] = pat[src], msk[src]
    return pat, msk, (100, 260)


def queries(pat, msk, b: int, seed: int):
    """``b`` queries: rotated copies of the two clusters' sources, a rotated
    copy of another entry with pattern bits flipped, and fresh templates."""
    rng = np.random.default_rng(seed + 1)
    src = np.array([100, 260, 37][:b])
    rot = np.array([7, -15, 3][:b])
    qp = data.rotate_packed(pat[src], rot)
    qm = data.rotate_packed(msk[src], rot)
    if b > 2:
        qp[2] ^= np.eye(1, data.BITS_BYTES, 9, dtype=np.uint8)[0] * 0x21
    fresh = b - len(src)
    qp = np.concatenate([qp, rng.integers(0, 256, (fresh, data.BITS_BYTES), dtype=np.uint8)])
    qm = np.concatenate([qm, rng.integers(0, 256, (fresh, data.BITS_BYTES), dtype=np.uint8)])
    return qp, qm


def as_rows(results):
    return [(r.index, r.numerator, r.denominator, r.distance) for r in results]


@pytest.mark.parametrize("b,n", [(8, 300), (5, 300), (8, 333)],
                         ids=["b8-tail12", "b5-tail12", "b8-tail13"])
def test_match_equals_the_reference(b, n):
    """B = 8 (two groups of 4) and B = 5 (a group of 4 and a group of one)
    over four shards with short last chunks; the exact copies planted in
    different shards tie at distance 0 and the lowest global index wins:
    shard 3's over shards 0-2 and the tail's, shard 0's over the tail's."""
    pat, msk, sources = planted_db(n, seed=n + b)
    assert len({shard_of(e) for e in (100, 150, 170, 200)}) == 4
    eng = ShardedPlaintextEngine(pat, msk, cpu_mesh(4), chunk=CHUNK, storage="packed")
    assert eng.chunk == CHUNK and n % (4 * CHUNK)
    qp, qm = queries(pat, msk, b, seed=n)
    got = as_rows(eng.match(qp, qm))
    assert got == ref.match(pat, msk, qp, qm, "cpu", block=64)
    assert [got[0][:2], got[1][:2]] == [(sources[0], 0), (sources[1], 0)]


def old_blocked_local(eng, src) -> np.ndarray:
    """The layout the engine built on the host before it uploaded by chunk:
    this process's shards' slabs, uint8 [hi-lo, G, chunk, 1600]."""
    lo, hi = eng.db_span
    out = np.zeros((hi - lo, eng.g_blocks, eng.chunk, src.shape[1]), np.uint8)
    for j, li, s, e in _local_chunk_iter(src.shape[0], eng.chunk, eng.n_shards, lo, hi):
        if e > s:
            out[li, j, : e - s] = src[s:e]
    return out


@pytest.mark.parametrize("shape,ranks,me", [
    ((4, 1), [[0], [0], [0], [0]], 0),
    ((4, 1), [[0], [0], [1], [1]], 1),
    ((2, 2), [[0, 1], [2, 3]], 2),
    ((2, 2), [[0, 0], [0, 0]], 0),
], ids=["one-process", "rows-2-3-of-2-ranks", "2x2-rank-2", "2x2-one-process"])
def test_the_chunk_build_lays_out_the_old_bytes(shape, ranks, me):
    """Each device of each local shard holds, byte for byte, the slab of
    the whole-slab build, zero-padded tails included, on a process's rows
    of the ``"db"`` axis (``local_db_span``) too."""
    n = 333
    pat, msk, _ = planted_db(n, seed=5)
    devices = np.empty(shape, dtype=object)
    devices[:] = [[CPU] * shape[1]] * shape[0]
    mesh = Mesh(devices, np.array(ranks), process_index=me)
    eng = ShardedPlaintextEngine(pat, msk, mesh, chunk=CHUNK, storage="packed")
    lo, hi = local_db_span(mesh)
    want_p, want_m = old_blocked_local(eng, pat), old_blocked_local(eng, msk)
    assert sorted(eng._db) == list(range(lo, hi))
    for i, per_dev in eng._db.items():
        for db in per_dev.values():
            a, b = db.planes
            assert a.dtype == torch.uint8 and a.shape == (eng.g_blocks, CHUNK, data.BITS_BYTES)
            assert np.array_equal(a.numpy(), want_p[i - lo])
            assert np.array_equal(b.numpy(), want_m[i - lo])


def test_dense_storage_matches_packed():
    n = 300
    pat, msk, _ = planted_db(n, seed=9)
    qp, qm = queries(pat, msk, 4, seed=9)
    packed = ShardedPlaintextEngine(pat, msk, cpu_mesh(4), chunk=CHUNK, storage="packed")
    dense = ShardedPlaintextEngine(pat, msk, cpu_mesh(4), chunk=CHUNK, storage="dense")
    assert as_rows(dense.match(qp, qm)) == as_rows(packed.match(qp, qm))


class _Added:
    """What the calls inside the block added to the aggregates."""

    def __enter__(self):
        self.before = profiling.snapshot()
        return self

    def __exit__(self, *exc):
        after = profiling.snapshot()
        self.spans = {name: s["count"] - self.before["spans"].get(name, {"count": 0})["count"]
                      for name, s in after["spans"].items()}
        self.spans = {n: c for n, c in self.spans.items() if c}
        self.counters = {n: v - self.before["counters"].get(n, 0)
                         for n, v in after["counters"].items()}
        return False


@pytest.fixture(scope="module")
def engine():
    pat, msk, _ = planted_db(300, seed=3)
    qp, qm = queries(pat, msk, 8, seed=3)
    return ShardedPlaintextEngine(pat, msk, cpu_mesh(4), chunk=CHUNK), qp, qm


def test_a_match_records_its_spans(engine, tmp_path):
    """One request: the root ``iris.match`` with its request number, the
    query prep (``_queries`` and the spread to the shards), one launch a
    shard, the cross-card fold, the result's wait, and four shard bodies."""
    eng, qp, qm = engine
    with _Added() as added, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True) as prof:
        eng.match(qp, qm)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    roots = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
             if e.get("name") == "iris.match"]
    assert len(roots) == 1 and isinstance(roots[0]["args"]["request"], int)
    assert added.spans["iris.match"] == 1 and added.spans["iris.launch"] == 4
    assert added.spans["iris.fold"] == 1 and added.spans["iris.wait"] >= 1
    assert added.spans["iris.query_prep"] >= 2
    assert added.counters["iris.shard.bodies"] == 4


def test_find_under_records_its_root_and_bodies(engine):
    eng, qp, qm = engine
    with _Added() as added, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        hits = eng.find_under(qp[:2], qm[:2], 0.2)
    assert [h[0].index for h in hits] == [100, 260]
    assert added.spans["iris.find_under"] == 1 and added.spans["iris.wait"] >= 1
    assert added.counters["iris.shard.bodies"] == 4


def test_nothing_is_recorded_without_a_capture(engine):
    eng, qp, qm = engine
    with _Added() as added:
        eng.match(qp, qm)
    assert not {k for k in added.spans if not k.startswith(profiling.SETUP)}
    assert not any(added.counters.values())


def test_the_build_is_one_set_up_span():
    pat, msk, _ = planted_db(300, seed=4)
    with _Added() as added:
        ShardedPlaintextEngine(pat, msk, cpu_mesh(4), chunk=CHUNK)
    assert added.spans["iris.setup.db_load"] == 1


def test_host_spectrum_copies_the_first_entries_as_u16():
    nd = torch.tensor(np.arange(2 * 3 * 10, dtype=np.int16).reshape(2, 3, 10) * 401)
    with _Added() as added, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = host_spectrum(nd, 7)
    assert got.dtype == np.uint16 and got.shape == (2, 3, 7)
    assert np.array_equal(got, nd[:, :, :7].numpy().astype(np.uint16))
    assert added.spans["iris.wait"] == 1


def test_sharded_min_fractions_equal_the_single_card_spectrum(engine):
    from mpc_iris_tpu_torch.models import PlaintextEngine

    eng, qp, qm = engine
    pat, msk, _ = planted_db(300, seed=3)
    one = PlaintextEngine(pat, msk, device="cpu", chunk=CHUNK)
    assert np.array_equal(eng.min_fractions(qp, qm), one.min_fractions(qp, qm))


@pytest.mark.parametrize("n,chunk", [(24_000_000, 16_384), (333, 32), (300, 32), (100, 128),
                                     (4 * 16_384, 16_384)])
def test_the_work_counts_each_shard_as_the_engine_lays_it_out(n, chunk):
    """``work/sharded_match.shard_entries`` against the engine's strided
    layout (every mask row of a random DB is nonzero, every padded row
    zero), and at 24M the entries a card of the four-card cell holds."""
    want = [0] * 4
    for _, li, s, e in _local_chunk_iter(n, chunk, 4, 0, 4):
        want[li] += e - s
    assert work.shard_entries(n, 4, chunk) == want
    if n == 24_000_000:
        assert want == [6_010_368, 5_996_544, 5_996_544, 5_996_544]
    if n < 1000:
        msk = np.random.default_rng(n).integers(1, 256, (n, data.BITS_BYTES), dtype=np.uint8)
        eng = ShardedPlaintextEngine(msk, msk, cpu_mesh(4), chunk=chunk)
        rows = [int(eng._db[i][CPU].planes[1].reshape(-1, data.BITS_BYTES).any(1).sum())
                for i in range(4)]
        assert rows == work.shard_entries(n, 4, eng.chunk)


def test_the_work_bound_of_the_cell():
    """24M over four cards at B = 8: one int8 launch of two groups of 4 a
    card, bound by its operations; the sum over the cards is the whole DB's
    operations at the int8 peak."""
    from benchmark.peaks import HBM_BYTES_PER_S, INT8_OPS

    config = {"entries": 24_000_000, "mesh": [4, 1]}
    w = work.work(config, {"batch": 8})
    assert w["comparisons"] == 8 * 24_000_000 and w["db_bytes"] == 76_800_000_000
    assert w["packed_match_bound_s"] == pytest.approx(4 * 8 * 31 * 12_800 * 24e6 / INT8_OPS)
    assert w["packed_match_bound_s"] / 4 > 6_010_368 * 3_200 / HBM_BYTES_PER_S
    assert work.work(config, {"batch": 1})["packed_match_bound_s"] == 0  # the binary kernel
    two = work.work({**config, "mesh": [2, 2]}, {"batch": 8})["packed_match_bound_s"]
    assert two == pytest.approx(w["packed_match_bound_s"])


def _ctx(ops, by_card, busy, requests=2, **work_):
    trace = tr.Trace(window_s=1.0, busy_s=busy, requests=requests, device_ops=ops,
                     busy_by_card=by_card)
    return SimpleNamespace(trace=trace, work=work_, config={"mesh": [4, 1]}, traffic={})


def test_the_four_card_readers():
    from benchmark import manifest as mf

    overlap = mf.metric_reader("card_overlap_pct").read
    roof = mf.metric_reader("packed_match_roofline").read
    ops = [("void mpc_iris::packed_match_kernel<4, 2>", 0, 300_000_000),
           ("void mpc_iris::fold_parts_kernel", 0, 1_000_000),
           ("Memcpy HtoD (Pageable -> Device)", 0, 5_000_000)]
    together = _ctx(ops, {0: 0.5, 1: 0.5, 2: 0.5, 3: 0.5}, 0.5, packed_match_bound_s=0.06)
    in_turns = _ctx(ops, {0: 0.5, 1: 0.5, 2: 0.5, 3: 0.5}, 2.0)
    assert overlap(together) == pytest.approx(100.0)
    assert overlap(in_turns) == pytest.approx(25.0)
    assert overlap(_ctx(ops, {}, 0.0)) is None
    assert roof(together) == pytest.approx(100 * 0.06 / (0.301 / 2))
    assert roof(in_turns) is None  # no bound in the work
    assert roof(_ctx(ops[2:], {}, 0.0, packed_match_bound_s=0.06)) is None
