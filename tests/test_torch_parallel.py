"""The port's sharded and multi-process engines (mpc_iris_tpu_torch.parallel)
against the JAX package's, on the same numpy inputs, on the CPU. The JAX
engines run on the conftest's 8 virtual CPU devices, the port's on meshes of
repeated CPU devices (``devices=[cpu] * k``). Exact, tolerance 0: winners as
(index, n, d, f64), spectra, audit lists, u16 dot streams and checksums."""

import asyncio
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mpc_iris_tpu import native
from mpc_iris_tpu.models import engines as jeng
from mpc_iris_tpu.parallel import ShardedKeyedShareEngine as JaxShardedKeyed
from mpc_iris_tpu.parallel import ShardedMasksEngine as JaxShardedMasks
from mpc_iris_tpu.parallel import ShardedPlaintextEngine as JaxShardedPlain
from mpc_iris_tpu.parallel import ShardedShareEngine as JaxShardedShare
from mpc_iris_tpu.parallel import make_mesh as jax_make_mesh
from mpc_iris_tpu.parallel import mesh_shape_for as jax_mesh_shape_for
from mpc_iris_tpu.parallel import multihost as jax_multihost
from mpc_iris_tpu.parallel.sharded import effective_chunk as jax_effective_chunk
from mpc_iris_tpu.parallel.sharded import local_db_span as jax_local_db_span
from mpc_iris_tpu.ops.encode import encode_template
from mpc_iris_tpu.ops.select_pallas import fold_candidates as jax_fold_candidates
from mpc_iris_tpu.types import EncodedBits, Template
from mpc_iris_tpu_torch.models import KeyedShareEngine, PlaintextEngine
from mpc_iris_tpu_torch.models.engines import find_under_from_fractions, prepare_query_planes
from mpc_iris_tpu_torch.ops import chacha as tcha
from mpc_iris_tpu_torch.ops import packed_match as tpm
from mpc_iris_tpu_torch.ops import select as tsel
from mpc_iris_tpu_torch.parallel import (
    ShardedKeyedShareEngine,
    ShardedMasksEngine,
    ShardedPlaintextEngine,
    ShardedShareEngine,
    fraction_allmin,
    make_mesh,
    mesh_shape_for,
    multihost,
)
from mpc_iris_tpu_torch.parallel.mesh import Mesh
from mpc_iris_tpu_torch.parallel.party_smoke import KEY, dots_digest, run_party, under_digest
from mpc_iris_tpu_torch.parallel.sharded import effective_chunk, local_db_span
from mpc_iris_tpu_torch.smoke_data import make_data, query_rows

CPU = torch.device("cpu")


def cpu_mesh(db, batch=1):
    return make_mesh(db, batch, devices=[CPU] * (db * batch))


def jmesh(db, batch=1):
    return jax_make_mesh(db=db, batch=batch, devices=jax.devices()[: db * batch])


def rows(results):
    return [(r.index, r.distance, r.numerator, r.denominator) for r in results]


def lists(res):
    return [[(m.index, m.distance, m.numerator, m.denominator) for m in row] for row in res]


@pytest.fixture(scope="module")
def data():
    """tests/test_parallel.py's 19-entry data (seed 7, a near-match planted
    at 11), with 9 queries: its 2 and rotated copies of 7 DB entries."""
    rng = np.random.default_rng(7)
    queries = [Template.random(rng) for _ in range(2)]
    db = [Template.random(rng) for _ in range(19)]
    db[11] = queries[1].rotated(-4)
    shares = np.stack([EncodedBits.random(rng).data for _ in range(19)])
    queries += [db[i].rotated(r) for i, r in ((0, 0), (3, 2), (5, -7), (16, 1), (18, 0),
                                              (7, 15), (12, -15))]
    pack = lambda ts, f: np.stack([getattr(t, f).data for t in ts])
    return (pack(queries, "pattern"), pack(queries, "mask"), pack(db, "pattern"),
            pack(db, "mask"), shares)


# ------------------------------------------------------------------ helpers


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12])
def test_mesh_shape_for_equals_jax(n):
    for b in (None, 1, 2, 3, 8, 64, 128):
        assert mesh_shape_for(n, batch_size=b) == jax_mesh_shape_for(n, batch_size=b)


@pytest.mark.parametrize("rows_,d", [(0, 4), (19, 8), (37, 4), (100_000, 8), (1 << 20, 4),
                                     (8229, 4)])
def test_effective_chunk_equals_jax(rows_, d):
    for chunk in (2, 4, 100, 512, 16384, 32768):
        want = jax_effective_chunk(chunk, rows_, d)
        assert effective_chunk(chunk, rows_, d) == want
        on_card = effective_chunk(chunk, rows_, d, "cuda")
        assert on_card % 8 == 0 and want <= on_card < want + 8


@pytest.mark.parametrize("n,chunk,db,batch", [(37, 4, 4, 2), (19, 2, 8, 1), (100, 16, 2, 1),
                                              (8229, 512, 4, 1)])
def test_local_entry_spans_equal_jax(n, chunk, db, batch):
    """Single process: the spans tile [0, N) in strided blocks, ragged tail
    included, exactly as the reference's."""
    spans = multihost.local_entry_spans(n, chunk, cpu_mesh(db, batch))
    assert spans == jax_multihost.local_entry_spans(n, chunk, jmesh(db, batch))
    seen = np.zeros(n, dtype=int)
    for s, e in spans:
        seen[s:e] += 1
    assert (seen == 1).all()


def test_local_spans_apply_engine_chunk_clamp(monkeypatch):
    """The reference's simulated rank-1 regression: requested chunk 32768
    over 100,000 rows clamps to 12,500, so rank 1 of a 2-process, 8-shard
    party must load [50,000, 100,000); the same spans as the reference's."""
    ranks = np.repeat(np.arange(2), 4).reshape(8, 1)
    devs = np.empty((8, 1), dtype=object)
    devs[:] = CPU
    jdevs = np.array([SimpleNamespace(process_index=int(r)) for r in ranks.flat]).reshape(8, 1)
    jm = SimpleNamespace(axis_names=("db", "batch"), devices=jdevs, shape={"db": 8, "batch": 1})
    n, requested = 100_000, 32_768
    c = effective_chunk(requested, n, 8)
    assert c == 12_500
    for pid, want in ((1, [(4 * c, n)]), (0, [(0, 4 * c)])):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        got = multihost.local_entry_spans(n, requested, Mesh(devs, ranks, process_index=pid))
        assert got == jax_multihost.local_entry_spans(n, requested, jm) == want
    # the card's clamp rounds, and the spans follow it
    card = Mesh(devs, ranks, process_index=1)
    card.device_type = "cuda"
    assert multihost.local_entry_spans(n, requested, card) == [(4 * 12_504, n)]


def test_local_db_span_rejects_interleaved_ranks():
    devs = np.empty((4, 1), dtype=object)
    devs[:] = CPU
    mesh = Mesh(devs, np.array([[0], [1], [0], [1]]), process_index=0)
    with pytest.raises(ValueError, match="interleaves"):
        local_db_span(mesh)
    assert local_db_span(cpu_mesh(4, 2)) == (0, 4)


@pytest.mark.parametrize("pid", [0, 1, 2, 3])
def test_local_spans_on_2x2_mesh_equal_jax(monkeypatch, pid):
    """4 ranks of one card each on a (2, 2) mesh (``mesh_shape_for(4, 8)``):
    each 'db' row spans two ranks, and both load it. ``local_db_span`` and
    ``local_entry_spans`` equal the reference's for every rank."""
    ranks = np.arange(4).reshape(2, 2)
    devs = np.empty((2, 2), dtype=object)
    devs[:] = CPU
    jdevs = np.array([SimpleNamespace(process_index=int(r)) for r in ranks.flat]).reshape(2, 2)
    jm = SimpleNamespace(axis_names=("db", "batch"), devices=jdevs, shape={"db": 2, "batch": 2})
    monkeypatch.setattr(jax, "process_index", lambda: pid)
    assert mesh_shape_for(4, 8) == (2, 2)
    mesh = Mesh(devs, ranks, process_index=pid)
    assert local_db_span(mesh) == jax_local_db_span(jm) == (pid // 2, pid // 2 + 1)
    for n, chunk in ((19, 2), (1000, 128), (100_000, 32_768)):
        assert multihost.local_entry_spans(n, chunk, mesh) == \
            jax_multihost.local_entry_spans(n, chunk, jm)


def test_2x2_four_rank_party_equals_jax():
    """Four processes of one party on a (2, 2) mesh over gloo, every row
    outside a rank's local spans poisoned: the B = 8 winners, the B = 2
    spectrum, the find_under lists and the share dots (MPC reply blocks)
    equal the JAX package's single-process sharded engines on a (2, 2) mesh
    of the clean data, and the keyed checksum the single-card engine's."""
    t = 0.47  # lists the planted self-matches and some random entries
    out = run_party(procs=4, backend="gloo", device="cpu", n=64, n_share=64, chunk=8,
                    batch=8, shards_per_rank=1, mesh_batch=2, threshold=t, timeout=120)
    pat, msk, share = make_data(7, 64, 64)
    q = query_rows(64, 8)
    assert out["mesh"] == [2, 2] and out["procs"] == 4 and out["local_rows"] == 32
    ref = JaxShardedPlain(pat, msk, jmesh(2, 2), chunk=8)
    assert out["winners"] == [[r.index, r.numerator, r.denominator]
                              for r in ref.match(pat[q], msk[q])]
    assert [w[0] for w in out["winners"]] == q.tolist()
    assert out["spectrum_sha256"] == dots_digest(ref.min_fractions(pat[q[:2]], msk[q[:2]]))
    under = ref.find_under(pat[q], msk[q], t)
    assert out["under_sha256"] == under_digest(under)
    assert out["under_hits"] == sum(map(len, under)) > 8
    assert out["dots_sha256"] == dots_digest(
        JaxShardedShare(share, jmesh(2, 2), chunk=8).dots(pat[q], msk[q]))
    keyed = KeyedShareEngine(KEY, 0, 64, device="cpu", chunk=8)
    assert out["keyed_checksum"] == int(keyed.fold_pass_fn()(
        prepare_query_planes(torch.from_numpy(pat[q]), torch.from_numpy(msk[q]))[0]))


def test_fraction_allmin_equals_jax_fold():
    """Per-shard triples with equal fractions as different pairs and a
    duplicate whose lower index sits on a later shard."""
    rng = np.random.default_rng(5)
    d = rng.integers(0, 9, (6, 5)).astype(np.int32)
    n = (rng.integers(0, 9, (6, 5)) % np.maximum(d, 1)).astype(np.int32)
    idx = rng.permutation(30).reshape(6, 5).astype(np.int32)
    n[:, 0], d[:, 0], idx[:, 0] = [1, 2, 1, 0, 3, 2], [2, 4, 2, 0, 6, 4], [9, 3, 1, 4, 8, 2]
    want = jax_fold_candidates(n, d, idx, axis=0)
    got = fraction_allmin([torch.from_numpy(t) for t in n], [torch.from_numpy(t) for t in d],
                          [torch.from_numpy(t) for t in idx], CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2][0]) == 1


# ------------------------------------------------------------------ plaintext engine

# (mesh, chunk, storage, batches): every batch divides the batch axis, as
# under the reference's shard_map
PLAIN_CASES = [((4, 2), 4, "packed", (2,)), ((8, 1), 2, "packed", (1, 9)),
               ((8, 1), 2, "dense", (2,)), ((2, 1), 4, "dense", (1, 9))]


@pytest.fixture(scope="module")
def plain_engines(data):
    """One port and one JAX sharded engine per case, built once."""
    _, _, dpat, dmsk, _ = data
    out = {}
    for mesh, chunk, storage, _ in PLAIN_CASES:
        out[mesh, storage] = (
            ShardedPlaintextEngine(dpat, dmsk, cpu_mesh(*mesh), chunk=chunk, storage=storage),
            JaxShardedPlain(dpat, dmsk, jmesh(*mesh), chunk=chunk, storage=storage))
    return out


@pytest.mark.parametrize("mesh,storage,b", [(m, s, b) for m, _, s, bs in PLAIN_CASES for b in bs])
def test_sharded_match_equals_jax(data, plain_engines, mesh, storage, b):
    qpat, qmsk = data[:2]
    port, ref = plain_engines[mesh, storage]
    got = rows(port.match(qpat[:b], qmsk[:b]))
    assert got == rows(ref.match(qpat[:b], qmsk[:b]))
    if b > 2:
        assert [g[:2] for g in got[2:]] == [(i, 0.0) for i in (0, 3, 5, 16, 18, 7, 12)][:b - 2]


def test_sharded_match_batch_must_divide(data, plain_engines):
    qpat, qmsk = data[:2]
    with pytest.raises(ValueError, match="batch axis"):
        plain_engines[(4, 2), "packed"][0].match(qpat[:1], qmsk[:1])


@pytest.mark.parametrize("mesh,storage", [((8, 1), "packed"), ((2, 1), "dense")])
def test_sharded_audit_equals_jax(data, plain_engines, mesh, storage):
    qpat, qmsk = data[:2]
    port, ref = plain_engines[mesh, storage]
    nd = port.min_fractions(qpat[:2], qmsk[:2])
    assert nd.dtype == np.uint16 and nd.shape == (2, 2, 19)
    np.testing.assert_array_equal(nd, ref.min_fractions(qpat[:2], qmsk[:2]))
    t = float(np.median(nd[0] / np.maximum(nd[1], 1)))
    for compact_k in (None, 2):  # compacted; compacted with overflow
        assert lists(port.find_under(qpat[:2], qmsk[:2], t, compact_k=compact_k)) == \
            lists(ref.find_under(qpat[:2], qmsk[:2], t, compact_k=compact_k))


def _tie_db(seed, n, first, second, rotate):
    rng = np.random.default_rng(seed)
    if rotate:  # test_parallel.py:92-114: templates, the query a rotation of both
        db = [Template.random(rng) for _ in range(n)]
        q = Template.random(rng)
        db[first] = db[second] = q.rotated(3)
        return (q.pattern.data[None], q.mask.data[None],
                np.stack([t.pattern.data for t in db]), np.stack([t.mask.data for t in db]))
    dpat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)  # test_parallel.py:253-273
    dmsk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    dpat[second], dmsk[second] = dpat[first], dmsk[first]
    return dpat[first:first + 1].copy(), dmsk[first:first + 1].copy(), dpat, dmsk


@pytest.mark.parametrize("seed,first,second,rotate,storage", [(21, 4, 16, True, "packed"),
                                                              (11, 5, 16, False, "dense")])
def test_cross_shard_tie_prefers_lower_global_index(seed, first, second, rotate, storage):
    """Duplicate winners on different shards (chunk 4, D = 4: the lower
    index on shard 1, its twin on shard 0): the LOWER global index wins, in
    both storages, as in the reference."""
    qpat, qmsk, dpat, dmsk = _tie_db(seed, 32, first, second, rotate)
    want = rows(JaxShardedPlain(dpat, dmsk, jmesh(4), chunk=4, storage=storage).match(qpat, qmsk))
    assert want[0][0] == first
    for st in ("packed", "dense"):
        eng = ShardedPlaintextEngine(dpat, dmsk, cpu_mesh(4), chunk=4, storage=st)
        assert rows(eng.match(qpat, qmsk)) == want


@pytest.fixture(scope="module")
def realistic():
    """N = 8,192 + 37 packed entries; D = 4 at chunk 512 gives 5 chunks per
    shard (4 full blocks and a ragged one); planted self-matches on several
    shards and a duplicate pair with the lower index on the higher shard."""
    rng = np.random.default_rng(0x5A4D)
    n = 8192 + 37
    pat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    pat[2048 + 7], msk[2048 + 7] = pat[512 + 9], msk[512 + 9]  # shard 1 -> its twin on shard 0
    planted = np.array([512 + 9, 3, 1024 + 100, 1536 + 511, 8200, 4097, 6000, n - 1])
    q = np.concatenate([planted, rng.integers(0, n, 5)])
    return pat, msk, pat[q].copy(), msk[q].copy(), planted


@pytest.fixture(scope="module")
def realistic_engines(realistic):
    pat, msk = realistic[:2]
    return (ShardedPlaintextEngine(pat, msk, cpu_mesh(4), chunk=512),
            PlaintextEngine(pat, msk, device="cpu", chunk=512))


@pytest.fixture(scope="module")
def realistic_jax(realistic):
    """The reference's packed scan, ``_match_scan_packed`` called directly
    (its B <= 8 dispatch would run the Pallas kernel in interpret mode), over
    all 13 queries once: each query's winner does not depend on the others."""
    pat, msk, qpat, qmsk, _ = realistic
    q_enc, q_mask = jeng.prepare_query_planes(qpat, qmsk)
    db_pat, _ = jeng._pad_chunks(pat, 512)
    db_msk, _ = jeng._pad_chunks(msk, 512)
    return rows(jeng._results_from_triples(
        *jeng._match_scan_packed(q_enc, q_mask, db_pat, db_msk, fused=False)))


@pytest.mark.parametrize("b", [1, 8, 13])
def test_realistic_chunking_equals_single_and_jax(realistic, realistic_engines,
                                                  realistic_jax, b):
    """Sharded == single-card port engine == the reference's packed scan."""
    _, _, qpat, qmsk, planted = realistic
    sharded, single = realistic_engines
    assert sharded.chunk == 512 and sharded.g_blocks == 5
    got = rows(sharded.match(qpat[:b], qmsk[:b]))
    assert got == rows(single.match(qpat[:b], qmsk[:b]))
    assert got == realistic_jax[:b]
    assert [g[:2] for g in got[:8]] == [(int(p), 0.0) for p in planted[:b]]


def test_realistic_audit_equals_single(realistic, realistic_engines):
    _, _, qpat, qmsk, planted = realistic
    sharded, single = realistic_engines
    nd = single.min_fractions(qpat[:1], qmsk[:1])
    np.testing.assert_array_equal(sharded.min_fractions(qpat[:1], qmsk[:1]), nd)
    got = sharded.find_under(qpat[:1], qmsk[:1], 0.375)
    assert lists(got) == lists(find_under_from_fractions(nd, 0.375))
    assert [m.index for m in got[0]] == [planted[0], 2048 + 7]


# ------------------------------------------------------------------ MPC engines


@pytest.fixture(scope="module")
def share_world():
    rng = np.random.default_rng(0x5EA)
    share = rng.integers(0, 1 << 16, size=(37, 12800), dtype=np.uint16)
    share[0], share[1] = 0xFFFF, 0x8000
    masks = rng.integers(0, 256, (37, 1600), dtype=np.uint8)
    masks[3] = 0
    qpat = rng.integers(0, 256, (2, 1600), dtype=np.uint8)
    qmsk = rng.integers(0, 256, (2, 1600), dtype=np.uint8)
    return share, masks, qpat, qmsk


def _streams(eng, *q):
    return [np.concatenate(list(eng.stream(*q, entry_major=em)), axis=1 - em)
            for em in (False, True)]


@pytest.mark.parametrize("db,chunk", [(4, 2)])
def test_sharded_share_engine_equals_jax(share_world, db, chunk):
    share, _, qpat, qmsk = share_world
    port = ShardedShareEngine(share, cpu_mesh(db), chunk=chunk)
    ref = JaxShardedShare(share, jmesh(db), chunk=chunk)
    want = ref.dots(qpat, qmsk)
    got = port.dots(qpat, qmsk)
    assert got.dtype == np.uint16 and got.shape == (2, 37, 31)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(_streams(port, qpat, qmsk), _streams(ref, qpat, qmsk)):
        np.testing.assert_array_equal(g, w)
    # growth: the padded tail block is loaded again, full blocks kept
    grown = ShardedShareEngine(share[:21], cpu_mesh(db), chunk=chunk)
    kept = grown._blocks[: 21 // (db * chunk)]
    assert grown.refresh(share) == 16
    assert all(a is b for a, b in zip(grown._blocks, kept))
    np.testing.assert_array_equal(grown.dots(qpat, qmsk), want)
    with pytest.raises(ValueError, match="append-only"):
        grown.refresh(share[:4])


@pytest.mark.parametrize("storage", ["packed", "dense", "auto"])
def test_sharded_masks_engine_equals_jax(share_world, storage):
    _, masks, _, qmsk = share_world
    port = ShardedMasksEngine(masks, cpu_mesh(4), chunk=2, storage=storage)
    ref = JaxShardedMasks(masks, jmesh(4), chunk=2, storage=storage)
    assert port.storage == ref.storage
    for g, w in zip(_streams(port, qmsk), _streams(ref, qmsk)):
        np.testing.assert_array_equal(g, w)
    grown = ShardedMasksEngine(masks[:30], cpu_mesh(4), chunk=2, storage=storage)
    assert grown.refresh(masks) == 7 and grown.refresh(masks) == 0
    np.testing.assert_array_equal(grown.dots(qmsk), ref.dots(qmsk))


@pytest.fixture(scope="module")
def keyed_world(share_world):
    """Share stream 1 of a 3-way split of 64 encoded templates, 64 rows: 2
    blocks of 4 shards x 8 (``native.share_split`` writes stream s < 2 as
    the pure keystream a keyed party regenerates)."""
    rng = np.random.default_rng(31)
    enc = np.stack([encode_template(Template.random(rng)).data for _ in range(64)])
    key = native.derive_insecure_key(31)
    return key, native.share_split(enc, 3, key)[1], *share_world[2:]


def test_sharded_keyed_engine_equals_jax(keyed_world):
    """Dots and streams byte-equal to the reference's sharded engine over the
    same share rows and to the single-card keyed engine; a count that leaves
    padding rows cannot fold, and refresh grows the count."""
    key, share, qpat, qmsk = keyed_world
    port = ShardedKeyedShareEngine(key, 1, 64, cpu_mesh(4), chunk=8)
    ref = JaxShardedShare(share, jmesh(4), chunk=8)
    want = ref.dots(qpat, qmsk)
    np.testing.assert_array_equal(port.dots(qpat, qmsk), want)
    np.testing.assert_array_equal(
        KeyedShareEngine(key, 1, 64, device="cpu", chunk=8).dots(qpat, qmsk), want)
    for g, w in zip(_streams(port, qpat, qmsk), _streams(ref, qpat, qmsk)):
        np.testing.assert_array_equal(g, w)
    short = ShardedKeyedShareEngine(key, 1, 37, cpu_mesh(4), chunk=8)
    np.testing.assert_array_equal(short.dots(qpat, qmsk), want[:, :37])
    for eng in (short, JaxShardedKeyed(key, 1, 37, jmesh(4), chunk=8)):
        with pytest.raises(ValueError, match="phantom"):
            eng.fold_pass_fn()
    assert short.refresh(64) == 27 and short.num_blocks() == 2
    np.testing.assert_array_equal(short.dots(qpat, qmsk), want)
    with pytest.raises(ValueError, match="append-only"):
        short.refresh(3)


def test_sharded_keyed_fold_equals_jax(keyed_world):
    """The fold-pass checksum equals the reference sharded keyed engine's and
    the uint32 sum of the dots (the reference compiles ChaCha20 here, about
    13 s on a cold compile cache)."""
    key, share, qpat, qmsk = keyed_world
    port = ShardedKeyedShareEngine(key, 1, 64, cpu_mesh(4), chunk=8)
    q = prepare_query_planes(torch.from_numpy(qpat), torch.from_numpy(qmsk))[0]
    got = int(port.fold_pass_fn()(q))
    assert got == int(ShardedShareEngine(share, cpu_mesh(4), chunk=8).dots(qpat, qmsk)
                      .astype(np.uint64).sum()) & 0xFFFFFFFF
    ref = JaxShardedKeyed(key, 1, 64, jmesh(4), chunk=8)
    assert got == int(np.asarray(ref.fold_pass_fn()(q.numpy())))


def test_cpu_sharded_engines_never_launch(data, share_world):
    """Every kernel wrapper takes its plain version for CPU tensors: no
    launch through any sharded path."""
    def counts():
        return (tsel.select_chunk.launches, tpm.match_packed_small_b.launches,
                tpm.fractions_packed_small_b.launches, tcha.share_planes_kernel.launches)

    qpat, qmsk, dpat, dmsk, shares = data
    before = counts()
    eng = ShardedPlaintextEngine(dpat, dmsk, cpu_mesh(2), chunk=4)
    eng.match(qpat[:1], qmsk[:1])
    eng.match(qpat, qmsk)
    eng.find_under(qpat[:1], qmsk[:1], 0.4)
    ShardedKeyedShareEngine(bytes(32), 0, 16, cpu_mesh(2), chunk=8).dots(qpat[:1], qmsk[:1])
    assert counts() == before


def test_no_card_raises():
    """A CUDA mesh, the default mesh and the default NCCL party need a card;
    none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card error cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh(4, devices=[torch.device("cuda")] * 4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.init_party("127.0.0.1:1", 2, 0)
    multihost.init_party()  # a single process: nothing to join
    assert multihost.party_info()["process_count"] == 1


# ------------------------------------------------------------------ multi-process


def test_run_party_needs_a_device():
    """run_party has no default device: a caller that names none is refused
    before any rank process starts, rather than put on the CPU."""
    with pytest.raises(TypeError, match="device"):
        run_party(2)


def test_two_rank_gloo_party_equals_single_process():
    """Two processes of one party, 2 CPU shards each, every row outside a
    rank's local spans poisoned: winners, the B = 1 spectrum, the share dots
    and the keyed checksum equal the single-process engines on clean data."""
    out = run_party(procs=2, backend="gloo", device="cpu", n=64, n_share=64, chunk=8,
                    batch=2, timeout=120)
    pat, msk, share = make_data(7, 64, 64)
    q = query_rows(64, 2)
    single = PlaintextEngine(pat, msk, device="cpu", chunk=8)
    assert out["backend"] == "gloo" and out["shards"] == 4 and out["local_rows"] == 32
    assert out["winners"] == [[r.index, r.numerator, r.denominator]
                              for r in single.match(pat[q], msk[q])]
    assert [w[0] for w in out["winners"]] == q.tolist()
    assert out["spectrum_sha256"] == dots_digest(single.min_fractions(pat[q[:1]], msk[q[:1]]))
    assert out["dots_sha256"] == dots_digest(
        ShardedShareEngine(share, cpu_mesh(4), chunk=8).dots(pat[q], msk[q]))
    assert out["dots_sha256"] == dots_digest(
        JaxShardedShare(share, jmesh(4), chunk=8).dots(pat[q], msk[q]))
    keyed = KeyedShareEngine(KEY, 0, 64, device="cpu", chunk=8)
    assert out["keyed_checksum"] == int(keyed.fold_pass_fn()(
        prepare_query_planes(torch.from_numpy(pat[q]), torch.from_numpy(msk[q]))[0]))


def test_jax_roles_serve_sharded_port_engines():
    """The JAX ParticipantServer serves the port's sharded parties (two keyed,
    one data share) over TCP and the JAX Coordinator runs over the port's
    ShardedMasksEngine: the winners equal the oracle, on the reference wire
    and the batched one."""
    from mpc_iris_tpu.protocol import Coordinator, ParticipantServer

    rng = np.random.default_rng(23)
    db = [Template.random(rng) for _ in range(29)]
    query = Template.random(rng)
    db[21] = query.rotated(-4)
    enc = np.stack([encode_template(t).data for t in db])
    key = native.derive_insecure_key(7)
    shares = native.share_split(enc, 3, key)
    masks = np.stack([t.mask.data for t in db])
    mesh = cpu_mesh(4)
    parties = [ShardedKeyedShareEngine(key, 0, 29, mesh, chunk=2),
               ShardedKeyedShareEngine(key, 1, 29, mesh, chunk=4),
               ShardedShareEngine(shares[2], mesh, chunk=2)]
    masks_engine = ShardedMasksEngine(masks, mesh, chunk=2)

    async def serve(wire, ask):
        servers = [ParticipantServer(e, "127.0.0.1", 0, wire=wire) for e in parties]
        addrs = [await s.start() for s in servers]
        try:
            return await ask(Coordinator(masks_engine, addrs, strict_scan=True))
        finally:
            for s in servers:
                await s.close()

    async def go():
        return (await serve("reference", lambda c: c.query(query)),
                await serve("batched", lambda c: c.query_batch([query, db[2]])))

    one, batch = asyncio.run(go())
    oracle = np.array([query.distance(t) for t in db])
    assert (one.index, one.distance, one.total) == (21, oracle.min(), 29)
    assert [(o.index, o.distance) for o in batch] == [(21, oracle.min()), (2, 0.0)]

