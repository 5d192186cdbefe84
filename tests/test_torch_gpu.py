"""The port's CUDA kernels against their plain versions on the card, and the
engine on the card against the engine on the CPU.

Marked ``gpu``; each test skips where no CUDA card is present. This file
imports no jax, so on a card machine without jax it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from mpc_iris_tpu import native
from mpc_iris_tpu_torch.models import KeyedShareEngine, MasksEngine, PlaintextEngine, ShareEngine
from mpc_iris_tpu_torch.models.engines import _pad_chunks, prepare_query_planes
from mpc_iris_tpu_torch.ops import b1_packed as tb1
from mpc_iris_tpu_torch.ops import chacha as tcha
from mpc_iris_tpu_torch.ops import dot as tdot
from mpc_iris_tpu_torch.ops import gemm as tgemm
from mpc_iris_tpu_torch.ops import keyed_dot as tkd
from mpc_iris_tpu_torch.ops import packed_match as tpm
from mpc_iris_tpu_torch.ops import select as tsel
from mpc_iris_tpu_torch.ops import select_probes as tsp
from mpc_iris_tpu_torch.ops import stream_probes as tstream
from mpc_iris_tpu_torch.ops.encode import share_split_device
from mpc_iris_tpu_torch.protocol import coordinator as tcoord
from mpc_iris_tpu_torch.smoke_data import BISECT_RANGES, probe_inputs, stream_inputs, tie_case

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n_cols,offset", [(1, 0), (1000, 77), (4096, 1 << 20)])
def test_select_chunk_kernel(cuda, n_cols, offset):
    dot, den = tsel.planted_select_case(np.random.default_rng(n_cols), n_cols=4096)
    dot = torch.from_numpy(dot[:, :n_cols].copy()).to(cuda)
    den = torch.from_numpy(den[:, :n_cols].copy()).to(cuda)
    before = tsel.select_chunk.launches
    got = torch.stack(tsel.select_chunk(dot, den, offset))
    torch.cuda.synchronize()
    assert tsel.select_chunk.launches == before + 1
    want = torch.stack(tsel.select_chunk_reference(dot, den, offset))
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        tsel.select_chunk(dot.to(torch.int16), den.to(torch.int16), offset)


# Batches of every query group size of the launch plan, more than one group
# (16, 33); entry counts (912, 1000, 704, 800) that no entry tile (128 or 256
# entries) divides; planted_packed_case's rotation ties and duplicates at
# rows 129 and 257 (congruent mod 128).
PACKED_CASES = [(1, 304), (2, 1000), (3, 1000), (8, 64), (16, 200), (33, 304)]


def _packed_case(cuda, b, chunk):
    pat, msk, qpat, qmsk = tpm.planted_packed_case(np.random.default_rng(b), b=b)
    db_pat = torch.from_numpy(_pad_chunks(pat, chunk)[0]).to(cuda)
    db_msk = torch.from_numpy(_pad_chunks(msk, chunk)[0]).to(cuda)
    q_enc, q_mask = prepare_query_planes(torch.from_numpy(qpat).to(cuda),
                                         torch.from_numpy(qmsk).to(cuda))
    return q_enc, q_mask, db_pat, db_msk


@pytest.mark.parametrize("b,chunk", PACKED_CASES)
def test_match_packed_small_b_kernel(cuda, b, chunk):
    args = _packed_case(cuda, b, chunk)
    before = tpm.match_packed_small_b.launches
    got = tpm.match_packed_small_b(*args)
    torch.cuda.synchronize()
    assert tpm.match_packed_small_b.launches == before + len(tpm._launch_plan(b))
    # the plain version's int8 product on the card needs chunk % 8 == 0
    want = tpm.match_packed_small_b_reference(*args)
    assert torch.equal(got, want)
    assert int(got[2, 0]) == 129
    if b > 2:
        assert int(got[1, 2]) == 0 and int(got[2, 2]) == 0  # the all-invalid query


@pytest.mark.parametrize("b,chunk", PACKED_CASES)
def test_fractions_packed_small_b_kernel(cuda, b, chunk):
    """Ragged entry tiles at every chunk; the padded tail reports (0, 0)."""
    args = _packed_case(cuda, b, chunk)
    before = tpm.fractions_packed_small_b.launches
    got = tpm.fractions_packed_small_b(*args)
    torch.cuda.synchronize()
    assert tpm.fractions_packed_small_b.launches == before + len(tpm._launch_plan(b))
    want = tpm.fractions_packed_small_b_reference(*args)
    assert got.dtype == torch.int16 and torch.equal(got, want)
    assert int(got[0, 0, 129]) == 0 and int(got[0, 0, 257]) == 0
    assert not got[:, :, 700:].any()


def test_packed_kernel_canaries(cuda):
    tpm.check_match_packed_small_b(cuda)
    tpm.check_fractions_packed_small_b(cuda)


@pytest.mark.parametrize("storage", ["packed", "dense"])
def test_audit_on_card_equals_cpu(cuda, storage):
    rng = np.random.default_rng(11)
    pat = rng.integers(0, 256, (3001, 1600), dtype=np.uint8)
    msk = rng.integers(0, 256, (3001, 1600), dtype=np.uint8)
    pat[2500], msk[2500] = pat[17], msk[17]
    card = PlaintextEngine(pat, msk, device=cuda, chunk=1001, storage=storage)
    host = PlaintextEngine(pat, msk, device="cpu", chunk=1001, storage=storage)
    for b in (1, 8, 9):
        q = rng.integers(0, 3001, b)
        q[0] = 17
        nd = card.min_fractions(pat[q], msk[q])
        np.testing.assert_array_equal(nd, host.min_fractions(pat[q], msk[q]))
        t = float(np.quantile(nd[0, 0] / np.maximum(nd[1, 0], 1), 0.01))
        for compact_k in (None, 64, 4):  # compacted; compacted with overflow
            got = card.find_under(pat[q], msk[q], t, compact_k=compact_k)
            assert [[(m.index, m.distance, m.numerator, m.denominator) for m in row]
                    for row in got] == \
                [[(m.index, m.distance, m.numerator, m.denominator) for m in row]
                 for row in host.find_under(pat[q], msk[q], t, compact_k=compact_k)]
            assert [m.index for m in got[0][:2]] == [17, 2500]


@pytest.mark.parametrize("storage", ["packed", "dense"])
def test_engine_on_card_equals_cpu(cuda, storage):
    rng = np.random.default_rng(7)
    pat = rng.integers(0, 256, (3001, 1600), dtype=np.uint8)
    msk = rng.integers(0, 256, (3001, 1600), dtype=np.uint8)
    pat[2500], msk[2500] = pat[17], msk[17]
    card = PlaintextEngine(pat, msk, device=cuda, chunk=1001, storage=storage)
    assert card.chunk % 8 == 0
    host = PlaintextEngine(pat, msk, device="cpu", chunk=1001, storage=storage)
    for b in (1, 8, 9, 40):
        q = rng.integers(0, 3001, b)
        q[0] = 17
        got = [(r.index, r.numerator, r.denominator) for r in card.match(pat[q], msk[q])]
        assert got == [(r.index, r.numerator, r.denominator)
                       for r in host.match(pat[q], msk[q])]
        assert got[0] == (17, 0, got[0][2])
    np.testing.assert_array_equal(card.distances(pat[:2], msk[:2]),
                                  host.distances(pat[:2], msk[:2]))


@pytest.mark.parametrize("row0,n_rows", [(0xFFFFFF80, 128), (0xFFFFFFC0, 128),
                                         (0xFFFFFFF0, 128), (0, 1), (12345, 300)])
def test_share_planes_kernel(cuda, row0, n_rows):
    """Kernel (d) against its plain version: no carry, a carry at a 64-row
    boundary, a carry mid-launch, ragged row counts; the largest valid stream
    id and a key with high bits set."""
    kw = tcha.key_tensor(native.derive_insecure_key(12345), cuda)
    before = tcha.share_planes_kernel.launches
    got = tcha.share_planes_kernel(kw, 0xFFFFFFFE, row0, n_rows)
    torch.cuda.synchronize()
    assert tcha.share_planes_kernel.launches == before + 1
    want = tcha.share_planes_natural(kw, 0xFFFFFFFE, row0, n_rows)
    assert all(g.dtype == torch.int8 and torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        tcha.share_planes_kernel(kw.to(torch.int64), 0, 0, 1)
    with pytest.raises(ValueError):
        tcha.share_planes_kernel(kw, 0, 0, 0)


# Ragged shapes of both operands (no tile of either divides them) and every
# tile width of the first operand (32, 64, 128 and more than one tile).
@pytest.mark.parametrize("m,n", [(1, 1), (31, 300), (64, 256), (200, 1000), (300, 513)])
def test_int8_gemm_kernel(cuda, m, n):
    rng = np.random.default_rng(7 * m + n)
    q = torch.from_numpy(rng.integers(-128, 128, (m, 12_800), dtype=np.int8)).to(cuda)
    db = torch.from_numpy(rng.integers(-128, 128, (n, 12_800), dtype=np.int8)).to(cuda)
    before = tgemm.int8_gemm.launches
    got = tgemm.int8_gemm(q, db)
    torch.cuda.synchronize()
    assert tgemm.int8_gemm.launches == before + 1
    assert torch.equal(got, tgemm.int8_gemm_reference(q, db))
    with pytest.raises(ValueError):  # K not a multiple of the kernel's stage
        tgemm.int8_gemm(q[:, :96].contiguous(), db[:, :96].contiguous())


# The plan's edges: the keyed pass's M = 31 and 248 and a query tile's edge
# (256, 257) over a chunk; an N no 128-row tile divides; K = 128 (one
# stage); more tiles than SMs, so each block takes a second tile (M = 300:
# two query tiles, N = 16,384 + 77: 129 DB tiles).
@pytest.mark.parametrize("m,n,k", [(31, 16_384, 12_800), (248, 16_384, 12_800),
                                   (256, 1_000, 12_800), (257, 513, 12_800),
                                   (31, 16_461, 12_800), (64, 300, 128), (300, 16_461, 256),
                                   (4_096, 2_000, 384)])
def test_int8_gemm_kernel_plan_edges(cuda, m, n, k):
    rng = np.random.default_rng(m + n + k)
    q = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(cuda)
    db = torch.from_numpy(rng.integers(-128, 128, (n, k), dtype=np.int8)).to(cuda)
    plan = tgemm.gemm_plan(m, n, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (plan.sweeps > 1) == (plan.tiles > plan.grid)
    got = tgemm.int8_gemm(q, db)
    torch.cuda.synchronize()
    assert torch.equal(got, tgemm.int8_gemm_reference(q, db))
    if m > 16 and n % 8 == 0:
        assert torch.equal(got, torch._int_mm(q, db.T))


# Every block shape of the fused kernel (query rows up to 32, 64, 128, 256
# and past them), ragged DB rows, and the u64 nonce carry inside the chunk.
@pytest.mark.parametrize("variant", tkd.VARIANTS)
@pytest.mark.parametrize("m,n_rows,row0", [(24, 100, 0xFFFFFFD0), (31, 16_384, 0),
                                           (64, 300, 0xFFFFFF80), (100, 129, 0xFFFFFFC0),
                                           (248, 1000, 7 * 256), (300, 513, 0xFFFFFFF0)])
def test_keyed_share_dots_kernel(cuda, variant, m, n_rows, row0):
    rng = np.random.default_rng(m + n_rows)
    q = torch.from_numpy(rng.integers(-1, 2, (m, 12_800), dtype=np.int8)).to(cuda)
    kw = tcha.key_tensor(bytes(range(0x80, 0xA0)), cuda)
    before = dict(tkd.keyed_share_dots.launches)
    got = tkd.keyed_share_dots(q, kw, 0xFFFFFFFE, row0, n_rows, variant=variant)
    torch.cuda.synchronize()
    assert tkd.keyed_share_dots.launches[variant] == before[variant] + 1
    # the plain version's int8 product on the card takes row counts % 8 == 0:
    # its rows past n_rows are the next rows of the stream, cut off after
    want = tkd.keyed_share_dots_reference(q, kw, 0xFFFFFFFE, row0, -(-n_rows // 8) * 8)
    assert torch.equal(got, want[:, :n_rows])


def test_share_planes_kernel_rfc8439_block(cuda):
    """RFC 8439 section 2.3.2: stream id 0x09000000, row 0x4a000000, block 1."""
    lo, hi = tcha.share_planes_kernel(tcha.key_tensor(bytes(range(32)), cuda),
                                      0x09000000, 0x4a000000, 1)
    u16 = tdot.planes_to_shares(lo, hi)[0].cpu().numpy()
    words = [int(u16[w * 400 + 1]) | int(u16[6400 + w * 400 + 1]) << 16 for w in range(16)]
    assert np.array(words, "<u4").tobytes().hex() == (
        "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
        "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")


def test_share_engines_on_card_equal_cpu(cuda):
    """ShareEngine (resident and out of core), KeyedShareEngine (head + tail,
    fold pass), MasksEngine and the decode steps on the card against the same
    on the CPU; share_split_device on the card against the CPU."""
    rng = np.random.default_rng(3)
    n = 301
    pat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    qpat, qmsk = pat[[17, 2, 250]].copy(), msk[[17, 2, 250]].copy()
    key = native.derive_insecure_key(5)
    shares = share_split_device(pat, msk, 3, key, device=cuda, chunk=128)
    np.testing.assert_array_equal(
        shares, share_split_device(pat, msk, 3, key, device="cpu", chunk=128))
    plane_chunk = 2 * 12800 * 104
    parties = [(KeyedShareEngine(key, 0, n, device=dev, chunk=100, hbm_budget=plane_chunk),
                KeyedShareEngine(key, 1, n, device=dev, chunk=100, hbm_budget=0),
                ShareEngine(shares[2], device=dev, chunk=100, hbm_budget=plane_chunk))
               for dev in (cuda, "cpu")]
    assert parties[0][0].chunk == 104 and parties[0][0].resident_entries == 104
    for card, host in zip(*parties):
        for em in (False, True):
            np.testing.assert_array_equal(
                np.concatenate(list(card.stream(qpat, qmsk, entry_major=em)), axis=1 - em),
                np.concatenate(list(host.stream(qpat, qmsk, entry_major=em)), axis=1 - em))
    masks = [MasksEngine(msk, device=dev, chunk=100, storage=st)
             for dev in (cuda, "cpu") for st in ("dense", "packed")]
    dens = [np.concatenate(list(m.stream(qmsk, entry_major=True))) for m in masks]
    for d in dens[1:]:
        np.testing.assert_array_equal(d, dens[0])
    blocks = [np.concatenate(list(p.stream(qpat, qmsk, entry_major=True))) for p in parties[0]]
    for dev in (cuda, torch.device("cpu")):
        t = tuple(torch.from_numpy(b.view(np.int16)).to(dev) for b in blocks)
        den = torch.from_numpy(dens[0].view(np.int16)).to(dev)
        win = tcoord._sum_decode_argmin_device_batch(t, den).cpu()
        nd = tcoord._sum_decode_minfrac_device_batch(t, den).cpu()
        if dev.type == "cuda":
            card_win, card_nd = win, nd
    assert torch.equal(card_win, win) and torch.equal(card_nd, nd)
    assert win[2].tolist() == [17, 2, 250] and win[0].tolist() == [0, 0, 0]
    count = 3 * 104
    for dev in (cuda, "cpu"):
        eng = KeyedShareEngine(key, 1, count, device=dev, chunk=104, hbm_budget=plane_chunk)
        q = prepare_query_planes(torch.from_numpy(qpat).to(dev),
                                 torch.from_numpy(qmsk).to(dev))[0]
        got = int(eng.fold_pass_fn()(q))
        assert got == int(eng.dots(qpat, qmsk).astype(np.uint32).sum() & 0xFFFFFFFF)
        assert got == int(eng.fold_pass_fn(segments=2)(q))
        if dev == cuda:
            card_sum = got
    assert card_sum == got


def test_share_engine_prefetch_on_card_equals_cpu(cuda, monkeypatch):
    """ShareEngine under the default budget policy with nothing resident:
    every chunk goes host -> card through the prefetch worker, and refresh
    drops a pending prefetch of the padded tail. Equal to the CPU engine."""
    rng = np.random.default_rng(4)
    share = rng.integers(0, 1 << 16, (301, 12800), dtype=np.uint16)
    grown = np.concatenate([share, share[:50] ^ np.uint16(0x5A5A)])
    qpat = rng.integers(0, 256, (3, 1600), dtype=np.uint8)
    qmsk = rng.integers(0, 256, (3, 1600), dtype=np.uint8)
    monkeypatch.setenv("MPC_IRIS_HBM_BUDGET", "1")
    card = ShareEngine(share, device=cuda, chunk=104)
    assert card.resident_entries == 0 and card.num_chunks() == 3
    for src in (share, grown):
        host = ShareEngine(src, device="cpu", chunk=104, hbm_budget=0)
        for em in (False, True):
            np.testing.assert_array_equal(
                np.concatenate(list(card.stream(qpat, qmsk, entry_major=em)), axis=1 - em),
                np.concatenate(list(host.stream(qpat, qmsk, entry_major=em)), axis=1 - em))
        q = prepare_query_planes(torch.from_numpy(qpat).to(cuda),
                                 torch.from_numpy(qmsk).to(cuda))[0]
        card.dots_chunk(q, 1)  # prefetches chunk 2, the padded tail
        assert 2 in card._prefetch
        card.refresh(grown)
        assert not card._prefetch


def test_sharded_engines_on_card_equal_single(cuda):
    """The sharded engines on four shards of one card ([cuda] * 4) against
    the single-card engines, with each kernel's launches through the
    sharded path: (b) and (c) once per shard at B <= 8, (a) once per shard
    chunk at B = 13, (d) once per regenerated chunk."""
    from mpc_iris_tpu_torch.parallel import (
        ShardedKeyedShareEngine,
        ShardedMasksEngine,
        ShardedPlaintextEngine,
        ShardedShareEngine,
        make_mesh,
    )

    rng = np.random.default_rng(9)
    n = 4 * 1024 + 37
    pat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    pat[1029], msk[1029] = pat[300], msk[300]  # 300 on shard 1, its twin on shard 0
    q = np.concatenate([[300, 7, 2100, 4000, n - 1], rng.integers(0, n, 8)])
    mesh = make_mesh(4, devices=[cuda] * 4)
    sharded = ShardedPlaintextEngine(pat, msk, mesh, chunk=256)
    single = PlaintextEngine(pat, msk, device=cuda, chunk=256)
    assert sharded.chunk == 256 and sharded.g_blocks == 5

    def rows(res):
        return [(r.index, r.distance, r.numerator, r.denominator) for r in res]

    for b, kernel, per_call in ((1, tpm.match_packed_small_b, 4),
                                (8, tpm.match_packed_small_b, 4),
                                (13, tsel.select_chunk, 4 * 5)):
        before = kernel.launches
        got = rows(sharded.match(pat[q[:b]], msk[q[:b]]))
        assert kernel.launches == before + per_call
        assert got == rows(single.match(pat[q[:b]], msk[q[:b]]))
        assert [g[:2] for g in got[:5]] == [(int(i), 0.0) for i in q[:min(b, 5)]]
    before = tpm.fractions_packed_small_b.launches
    nd = sharded.min_fractions(pat[q[:8]], msk[q[:8]])
    assert tpm.fractions_packed_small_b.launches == before + 4
    np.testing.assert_array_equal(nd, single.min_fractions(pat[q[:8]], msk[q[:8]]))
    got = sharded.find_under(pat[q[:8]], msk[q[:8]], 0.375)
    assert got == single.find_under(pat[q[:8]], msk[q[:8]], 0.375)
    assert [m.index for m in got[0]] == [300, 1029]
    wide = ShardedPlaintextEngine(pat, msk, make_mesh(2, 2, devices=[cuda] * 4), chunk=256)
    assert rows(wide.match(pat[q[:8]], msk[q[:8]])) == rows(single.match(pat[q[:8]], msk[q[:8]]))

    key = native.derive_insecure_key(5)
    count = 4 * 256 * 2
    keyed = ShardedKeyedShareEngine(key, 0, count, mesh, chunk=256)
    ref = KeyedShareEngine(key, 0, count, device=cuda, chunk=256, hbm_budget=0)
    for b in (1, 8):
        qe = prepare_query_planes(torch.from_numpy(pat[q[:b]]).to(cuda),
                                  torch.from_numpy(msk[q[:b]]).to(cuda))[0]
        before = tcha.share_planes_kernel.launches
        got = int(keyed.fold_pass_fn()(qe))
        assert tcha.share_planes_kernel.launches == before + 8
        assert got == int(ref.fold_pass_fn()(qe))
    np.testing.assert_array_equal(keyed.dots(pat[q[:3]], msk[q[:3]]),
                                  ref.dots(pat[q[:3]], msk[q[:3]]))
    share = rng.integers(0, 1 << 16, (n, 12800), dtype=np.uint16)
    np.testing.assert_array_equal(
        ShardedShareEngine(share, mesh, chunk=256).dots(pat[q[:3]], msk[q[:3]]),
        ShareEngine(share, device=cuda, chunk=256).dots(pat[q[:3]], msk[q[:3]]))
    for storage in ("dense", "packed"):
        np.testing.assert_array_equal(
            ShardedMasksEngine(msk, mesh, chunk=256, storage=storage).dots(msk[q[:3]]),
            MasksEngine(msk, device=cuda, chunk=256).dots(msk[q[:3]]))


def test_coordinator_on_card_equals_cpu(cuda):
    """The Coordinator's rounds, staged in pinned memory, uploaded without
    waiting and decoded on the card, give the outcomes of the same rounds
    decoded on the CPU: three parties on the card (two keyed, one data
    share) over TCP, the reference and batched wires, argmin and audit."""
    import asyncio

    from mpc_iris_tpu_torch.protocol import Coordinator, ParticipantServer
    from mpc_iris_tpu_torch.types import Bits, Template

    rng = np.random.default_rng(61)
    n = 300
    pat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    queries = [Template(Bits(pat[7]), Bits(msk[7])).rotated(3),
               Template(Bits(pat[250]), Bits(msk[250])),
               Template.random(rng)]
    key = native.derive_insecure_key(5)
    data = share_split_device(pat, msk, 3, key, device=cuda, shares=[2])[0]
    parties = [KeyedShareEngine(key, 0, n, device=cuda, chunk=128),
               KeyedShareEngine(key, 1, n, device=cuda, chunk=128, hbm_budget=0),
               ShareEngine(data, device=cuda, chunk=128)]
    masks = MasksEngine(msk, device=cuda, chunk=128)

    async def go(dev, wire):
        servers = [ParticipantServer(e, "127.0.0.1", 0, wire=wire) for e in parties]
        addrs = [await s.start() for s in servers]
        coord = Coordinator(masks, addrs, batch_records=100, strict_scan=True, device=dev)
        try:
            if wire == "reference":
                return [await coord.query(queries[0]), await coord.query_under(queries[0], 0.45)]
            return (await coord.query_batch(queries)
                    + await coord.query_batch_under(queries, 0.45))
        finally:
            for s in servers:
                await s.close()

    for wire in ("reference", "batched"):
        got = asyncio.run(go(cuda, wire))
        assert repr(got) == repr(asyncio.run(go(torch.device("cpu"), wire)))
        assert (got[0].index, got[0].distance, got[0].total) == (7, 0.0, n)
    assert [o.index for o in got[:2]] == [7, 250]


def test_cli_match_packed_launches_kernel_b(cuda, tmp_path, capsys):
    """``cli.main(["match", ..., "--storage", "packed", "--batch", "8"])`` on
    the card: every self-match query at 0.0 through kernel (b), the same
    winner lines as the CLI on the CPU."""
    from mpc_iris_tpu_torch.cli import main

    db = str(tmp_path / "db.json")
    assert main(["generate", db, "5000", "--seed", "9"]) == 0
    argv = ["match", db, "--storage", "packed", "--batch", "8", "--seed", "4"]
    capsys.readouterr()
    before = tpm.match_packed_small_b.launches
    assert main([*argv, "--device", "cuda"]) == 0
    assert tpm.match_packed_small_b.launches > before
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("query ")]
    assert len(lines) == 8 and all(l.endswith("at distance 0.0") for l in lines)
    assert main([*argv, "--device", "cpu"]) == 0
    assert [l for l in capsys.readouterr().out.splitlines() if l.startswith("query ")] == lines


# An entry count no 256-entry block divides, a few blocks, and a slab of the
# probe's size; the query is entry 17, duplicated at n - 3 (a later index at
# the same distance 0).
@pytest.mark.parametrize("n", [1000, 4096, 65_536])
def test_b1_packed_kernels(cuda, n):
    rng = np.random.default_rng(n)
    pat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    pat[n - 3], msk[n - 3] = pat[17], msk[17]
    qp, qm = (torch.from_numpy(x[17:18].copy()).to(cuda) for x in (pat, msk))
    qe, qmk = tb1.prep_query(qp, qm)
    pat, msk = torch.from_numpy(pat).to(cuda), torch.from_numpy(msk).to(cuda)
    before = tb1.pk_dot.launches, tb1.pk_select.launches
    packed = tb1.pk_dot(qe, qmk, pat, msk)
    win = tb1.pk_select(qe, qmk, pat, msk)
    torch.cuda.synchronize()
    assert (tb1.pk_dot.launches, tb1.pk_select.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(packed, tb1.pk_dot_reference(qe, qmk, pat, msk))
    assert torch.equal(win, tb1.pk_select_reference(qe, qmk, pat, msk))
    q_enc, q_mask = prepare_query_planes(qp, qm)
    assert torch.equal(win, tpm.match_packed_small_b(q_enc, q_mask, pat.view(1, n, 1600),
                                                     msk.view(1, n, 1600)))
    assert win[:, 0].tolist()[::2] == [0, 17] and torch.equal(tb1.pk_dot_winner(packed), win)


# The probes' tile rules (8 queries a tile, 2,048 columns), random inputs in
# their range, the tie case (at tile_n 2,048 and 128; its f32 disagreement
# pair and congruent duplicates) and, for the int16 tree, a wrap.
@pytest.mark.parametrize("compare", tsp.COMPARES)
def test_select_variant_kernel(cuda, compare):
    rnd = probe_inputs(16, 8192, 7, cuda)
    ties = tuple(torch.from_numpy(x).to(cuda) for x in tie_case(16, 8192))
    for (dot, den), off, tile_n in ((rnd, 0, 2048), (rnd, 1 << 20, 256), (ties, 3, 2048),
                                    (ties, 3, 128)):
        before = tsp.select_variant.launches[compare]
        got = torch.stack(tsp.select_variant(dot, den, off, compare, tile_n))
        torch.cuda.synchronize()
        assert tsp.select_variant.launches[compare] == before + 1
        assert torch.equal(got, torch.stack(tsp.select_variant_reference(dot, den, off, compare,
                                                                         tile_n)))
    assert got[:, 0, 0].tolist() == ([12_799, 12_800, 3] if compare == "f32"
                                     else [12_798, 12_799, 1027])
    assert got[:, 1, 0].tolist() == [0, 4, 132]  # tile 128: the fold keeps 129 (+ 3)


@pytest.mark.parametrize("i16_tree", [False, True])
def test_select_lanes_kernel(cuda, i16_tree):
    rnd = probe_inputs(16, 8192, 8, cuda, torch.int16)
    ties = [torch.from_numpy(x).to(cuda) for x in tie_case(16, 8192, dtype=np.int16)]
    ties[0][5, 7] = -20_000  # den - dot = 32,800: wraps in the int16 tree
    for dot, den in (rnd, ties):
        before = tsp.select_lanes.launches["i16" if i16_tree else "i32"]
        got = tsp.select_lanes(dot, den, i16_tree)
        torch.cuda.synchronize()
        assert tsp.select_lanes.launches["i16" if i16_tree else "i32"] == before + 1
        assert torch.equal(got, tsp.select_lanes_reference(dot, den, i16_tree))
    assert got[0, [0, 256]].tolist() == [12_798, 1024]
    assert (int(got[0, 7]) < 0) == i16_tree


# The stream probes (csrc/stream_probes.cu): every variant of the probes'
# mains, on random inputs in each probe's range and on the tie case with
# queries 2 and 3 given zero denominators over the first column tile (stage
# 3's later-tile path), each equal to its plain version on the card.
@pytest.mark.parametrize("probe", tstream.PROBES)
def test_stream_probe_kernels(cuda, probe):
    fn = getattr(tstream, probe)
    if probe == "bisect":
        rnd = stream_inputs(16 * 32, 16_384, 9, cuda, BISECT_RANGES)
        dot, den = tie_case(16, 16_384)
    else:
        rnd = stream_inputs(1024, 8192, 9, cuda)
        dot, den = tie_case(32, 8192)
    dot[64:128, :2048], den[64:128, :2048] = 7, 0
    ties = tuple(torch.from_numpy(x).to(cuda) for x in (dot, den))
    for d, e in (rnd, ties):
        variants = tstream.main_variants(probe, d, e, 3)
        before = fn.launches
        for label, kernel, plain in variants:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
            assert all(torch.equal(g, w) for g, w in zip(got, want)), label
        assert fn.launches == before + len(variants)
