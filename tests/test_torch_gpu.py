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
from mpc_iris_tpu_torch.models.engines import (
    _pad_chunks,
    fractions_scan_packed_auto,
    match_scan_packed_auto,
    prepare_query_planes,
)
from mpc_iris_tpu_torch.ops import _build
from mpc_iris_tpu_torch.ops import b1_packed as tb1
from mpc_iris_tpu_torch.ops import chacha as tcha
from mpc_iris_tpu_torch.ops import dot as tdot
from mpc_iris_tpu_torch.ops import gemm as tgemm
from mpc_iris_tpu_torch.ops import keyed_dot as tkd
from mpc_iris_tpu_torch.ops import packed_gemm as tpg
from mpc_iris_tpu_torch.ops import packed_match as tpm
from mpc_iris_tpu_torch.ops import select as tsel
from mpc_iris_tpu_torch.ops import select_probes as tsp
from mpc_iris_tpu_torch.ops import stream_probes as tstream
from mpc_iris_tpu_torch.ops.encode import share_split_device
from mpc_iris_tpu_torch.ops.scan import _fused_rows
from mpc_iris_tpu_torch.protocol import coordinator as tcoord
from mpc_iris_tpu_torch.smoke_data import BISECT_RANGES, probe_inputs, stream_inputs, tie_case
from mpc_iris_tpu_torch.utils import profiling

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
# (16, 33), a group of 4 beside a group of one (5: the int8 and the binary
# kernel in one call); entry counts (912, 1000, 704, 800) that no entry tile
# (128 or 256 entries) divides; planted_packed_case's rotation ties and
# duplicates at rows 129 and 257 (congruent mod 128).
PACKED_CASES = [(1, 304), (2, 1000), (3, 1000), (8, 64), (16, 200), (33, 304), (5, 256)]


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
    before = tpm.fractions_packed_small_b.launches, tb1.launch_fractions.launches
    got = tpm.fractions_packed_small_b(*args)
    torch.cuda.synchronize()
    plan = tpm._launch_plan(b)
    assert tpm.fractions_packed_small_b.launches == before[0] + len(plan)
    # a group of one query launches the binary kernel, the others the int8 one
    assert tb1.launch_fractions.launches == before[1] + sum(qg == 1 for *_, qg in plan)
    want = tpm.fractions_packed_small_b_reference(*args)
    assert got.dtype == torch.int16 and torch.equal(got, want)
    assert int(got[0, 0, 129]) == 0 and int(got[0, 0, 257]) == 0
    assert not got[:, :, 700:].any()


# The group of 8 (csrc/packed_match_g8.cu, B = 8): 64 entries (the second
# consumer warpgroup of the only tile wholly past the end), 700 and 1,000
# (no 128-entry tile divides them), 20,001 (more tiles than an H100's
# clusters: each cluster walks several, with copies planted a walk step of
# 66 tiles apart)
GROUP8_N = [64, 700, 1000, 20_001]


def _group8_case(cuda, n: int):
    """8 queries and a DB of n entries in chunks of 304 (a zero-padded tail):
    query 0's self-match at 129 copied to 193 (the other consumer warpgroup
    of its tile) and 257 (another tile), at 20,001 also 129 + 128 x 66 and
    n - 3; sparse masks (rotation ties), an all-invalid entry (7) and a zero
    query (2) from planted_packed_case. At 64 entries: random entries, a
    copy of row 5 at 40 and query 0 = row 40."""
    rng = np.random.default_rng(n)
    if n < 700:
        pat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
        msk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
        pat[40], msk[40] = pat[5], msk[5]
        qpat, qmsk = pat[rng.integers(0, n, 8)].copy(), msk[rng.integers(0, n, 8)].copy()
        qpat[0], qmsk[0] = pat[40], msk[40]
        want0 = 5
    else:
        pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=n, b=8)
        for e in (193, 257) + ((129 + 128 * 66, n - 3) if n > 10_000 else ()):
            pat[e], msk[e] = pat[129], msk[129]
        want0 = 129
    db_pat = torch.from_numpy(_pad_chunks(pat, 304)[0]).to(cuda)
    db_msk = torch.from_numpy(_pad_chunks(msk, 304)[0]).to(cuda)
    q_enc, q_mask = prepare_query_planes(torch.from_numpy(qpat).to(cuda),
                                         torch.from_numpy(qmsk).to(cuda))
    return (q_enc, q_mask, db_pat, db_msk), want0


@pytest.mark.parametrize("n", GROUP8_N)
def test_match_group8_kernel(cuda, n):
    """B = 8 launches the group of 8 once, counted as
    ``iris.match.group8_launches`` under a capture, and equals the plain
    version and the groups-of-4 loop on the card, bit for bit; ties go to
    the lowest index, the zero query to (0, 0, 0)."""
    args, want0 = _group8_case(cuda, n)
    name = "iris.match.group8_launches"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        before = tpm.match_packed_small_b.launches
        counted = profiling.snapshot()["counters"].get(name, 0)
        got = tpm.match_packed_small_b(*args)
        torch.cuda.synchronize()
        assert tpm.match_packed_small_b.launches == before + 1
        assert profiling.snapshot()["counters"].get(name, 0) - counted == 1
    want = tpm.match_packed_small_b_reference(*args)
    assert torch.equal(got, want)
    fours = torch.empty_like(got)
    n_entries = args[2].shape[0] * args[2].shape[1]
    tpm._launch_int8_group(_build.library(), *args, n_entries, 4, fours, 8)
    assert torch.equal(fours, want)
    assert int(got[2, 0]) == want0 and int(got[0, 0]) == 0
    if n >= 700:
        assert int(got[1, 2]) == 0 and int(got[2, 2]) == 0  # the zero query


@pytest.mark.parametrize("n", GROUP8_N)
def test_fractions_group8_kernel(cuda, n):
    """The spectrum at B = 8 launches the group of 8 once, counted as
    ``iris.spectrum.group8_launches`` under a capture, and equals the plain
    version and the groups-of-4 loop on the card, bit for bit, as (n, d)
    pairs: the self-match and its copies (0, d), rotation ties as the
    earliest rotation's pair, the all-invalid entry, the zero query and the
    padded tail (0, 0)."""
    args, want0 = _group8_case(cuda, n)
    name = "iris.spectrum.group8_launches"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        before = tpm.fractions_packed_small_b.launches
        counted = profiling.snapshot()["counters"].get(name, 0)
        got = tpm.fractions_packed_small_b(*args)
        torch.cuda.synchronize()
        assert tpm.fractions_packed_small_b.launches == before + 1
        assert profiling.snapshot()["counters"].get(name, 0) - counted == 1
    want = tpm.fractions_packed_small_b_reference(*args)
    assert got.dtype == torch.int16 and torch.equal(got, want)
    fours = torch.empty_like(got)
    n_entries = args[2].shape[0] * args[2].shape[1]
    tpm._launch_int8_fractions(_build.library(), *args, n_entries, 4, fours[0, 0],
                               8 * n_entries)
    assert torch.equal(fours, want)
    copies = [want0, 40] if n < 700 else [129, 193, 257]
    assert not got[0, 0, copies].any() and got[1, 0, copies].all()
    assert not got[:, :, n:].any()
    if n >= 700:
        assert not got[:, :, 7].any() and not got[:, 2].any()


def test_find_under_b8_runs_the_group_of_8(cuda):
    """``PlaintextEngine(storage="packed").find_under`` at B = 8 launches the
    group of 8 once a request (counted under a capture) and gives the lists
    of the engine's plain versions on the CPU: near-copies of three queries
    planted in other chunks, a threshold that takes them and some random
    entries, each list's ties to the lowest index."""
    rng = np.random.default_rng(24)
    n = 5000
    pat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    q = rng.integers(0, n, 8)
    q[:3] = [17, 1200, 4999]
    for src, dst in ((17, 2500), (17, 3333), (1200, 64), (4999, 4000)):
        pat[dst], msk[dst] = pat[src], msk[src]
        pat[dst, :4] ^= 0xFF  # a near-copy: 32 pattern bits flipped
    card = PlaintextEngine(pat, msk, device=cuda, chunk=1024, storage="packed")
    host = PlaintextEngine(pat, msk, device="cpu", chunk=1024, storage="packed")
    nd = host.min_fractions(pat[q], msk[q])
    t = float(np.quantile(nd[0] / np.maximum(nd[1], 1), 0.002))

    def rows(res):
        return [[(m.index, m.distance, m.numerator, m.denominator) for m in row] for row in res]

    name = "iris.spectrum.group8_launches"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        counted = profiling.snapshot()["counters"].get(name, 0)
        got = rows(card.find_under(pat[q], msk[q], t))
        torch.cuda.synchronize()
        assert profiling.snapshot()["counters"].get(name, 0) - counted == 1
    assert got == rows(host.find_under(pat[q], msk[q], t))
    assert [m[0] for m in got[0][:3]] == [17, 2500, 3333]
    assert {m[0] for m in got[1]} >= {64, 1200} and {m[0] for m in got[2]} >= {4000, 4999}


def test_sharded_match_b8_runs_group8_on_every_shard(cuda):
    """ShardedPlaintextEngine on four shards of one card ([cuda] x 4) at
    B = 8: each shard launches the group of 8 once (4 counted under a
    capture), and the winners equal the single-card engine's; exact copies
    of entry 100 on every shard tie to the lowest global index."""
    from mpc_iris_tpu_torch.parallel import ShardedPlaintextEngine, make_mesh

    rng = np.random.default_rng(22)
    n = 4 * 2048 + 77
    pat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    for e in (300, 600, 900, n - 1):  # chunks 1, 2, 3 of 256 and the tail
        pat[e], msk[e] = pat[100], msk[100]
    q = np.concatenate([[900, 7, 2100, 4000], rng.integers(0, n, 4)])
    sharded = ShardedPlaintextEngine(pat, msk, make_mesh(4, devices=[cuda] * 4), chunk=256)
    single = PlaintextEngine(pat, msk, device=cuda, chunk=256)

    def rows(res):
        return [(r.index, r.distance, r.numerator, r.denominator) for r in res]

    name = "iris.match.group8_launches"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        counted = profiling.snapshot()["counters"].get(name, 0)
        got = rows(sharded.match(pat[q], msk[q]))
        torch.cuda.synchronize()
        assert profiling.snapshot()["counters"].get(name, 0) - counted == 4
    assert got == rows(single.match(pat[q], msk[q]))
    assert [g[:2] for g in got[:4]] == [(100, 0.0), (7, 0.0), (2100, 0.0), (4000, 0.0)]


def test_packed_kernel_canaries(cuda):
    tpm.check_match_packed_small_b(cuda)
    tpm.check_fractions_packed_small_b(cuda)
    tpm.check_packed_gemm(cuda)


# Batches past the small-batch dispatch; chunks of 304 and 1,000 entries are
# ragged against the 128-entry DB tile, and the 700 entries' last chunk is
# padded; planted_packed_case's rotation and index ties
GEMM_CASES = [(9, 304), (13, 1000), (33, 304), (128, 1000)]


@pytest.mark.parametrize("b,chunk", GEMM_CASES)
def test_packed_gemm_kernel(cuda, b, chunk):
    """Both products, the match's rows (32 a query) and the spectrum's (31),
    bit-equal to the plain version on every chunk, one launch each."""
    q_enc, q_mask, db_pat, db_msk = _packed_case(cuda, b, chunk)
    for rows in (_fused_rows, lambda q: q.reshape(-1, q.shape[2])):
        query = tpg.packed_query(rows(q_enc), rows(q_mask))
        for c in range(db_pat.shape[0]):
            before = tpg.packed_gemm.launches
            got = tpg.packed_gemm(query, db_pat[c], db_msk[c])
            torch.cuda.synchronize()
            assert tpg.packed_gemm.launches == before + 1
            want = tpg.packed_gemm_reference(query, db_pat[c], db_msk[c])
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("b", [9, 33])
def test_packed_gemm_counts_one_a_chunk_on_the_dispatch(cuda, b):
    """Under a capture, the dispatchers past the small batches launch the
    kernel and count ``iris.scan.packed_gemm_chunks`` once a chunk; the
    plain versions neither launch it nor count. Results equal."""
    args = _packed_case(cuda, b, 304)
    chunks = args[2].shape[0]
    name = "iris.scan.packed_gemm_chunks"
    runs = [(match_scan_packed_auto, tpm.match_packed_small_b_reference),
            (fractions_scan_packed_auto, tpm.fractions_packed_small_b_reference)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for scan, plain in runs:
            for fn, want in ((scan, chunks), (plain, 0)):
                launches = tpg.packed_gemm.launches
                counted = profiling.snapshot()["counters"].get(name, 0)
                fn(*args)
                torch.cuda.synchronize()
                assert tpg.packed_gemm.launches - launches == want
                assert profiling.snapshot()["counters"].get(name, 0) - counted == want
            assert torch.equal(scan(*args), plain(*args))


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


# pk_select_kernel at one entry, the tile edges (255, 256, 257 entries), the
# planted traps (700 entries: rotation ties, duplicates at 129 and 257) and
# one entry past a wave of 132 blocks of 256; a random query a noisy copy of
# entry a (a nonzero distance) with an exact duplicate of a at b, past a tile
# edge (255, 256) or in the next wave (33,791, 33,792).
PK_SELECT_N = [1, 255, 256, 257, 700, 132 * 256 + 1]


def _pk_select_case(n: int):
    rng = np.random.default_rng(n + 7)
    if n == 700:
        pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=n, b=1)
        return pat, msk, qpat, qmsk, 129
    pat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    a, b = (n - 2, n - 1) if n > 1000 else (255, 256)
    if b < n:
        pat[b], msk[b] = pat[a], msk[a]
    a = min(a, n - 1)
    qpat = pat[a:a + 1] ^ (rng.integers(0, 256, (1, 1600), dtype=np.uint8) & 0x11)
    return pat, msk, qpat, msk[a:a + 1].copy(), a


@pytest.mark.parametrize("n", PK_SELECT_N)
def test_pk_select_kernel(cuda, n):
    """pk_select (csrc/b1_packed.cu's pk_select_kernel) against its plain
    version, the int8 match kernel at a group of 2 with one query, and
    match_packed_small_b at B = 1, which launches the same kernel."""
    pat, msk, qpat, qmsk, a = _pk_select_case(n)
    qp, qm = (torch.from_numpy(x).to(cuda) for x in (qpat, qmsk))
    pat, msk = torch.from_numpy(pat).to(cuda), torch.from_numpy(msk).to(cuda)
    qe, qmk = tb1.prep_query(qp, qm)
    before = tb1.pk_select.launches, tpm.match_packed_small_b.launches
    got = tb1.pk_select(qe, qmk, pat, msk)
    q_enc, q_mask = prepare_query_planes(qp, qm)
    db = (pat.view(1, n, 1600), msk.view(1, n, 1600))
    route = tpm.match_packed_small_b(q_enc, q_mask, *db)
    torch.cuda.synchronize()
    assert (tb1.pk_select.launches, tpm.match_packed_small_b.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    # the plain version's int8 product on the card needs a multiple of 8 entries;
    # the zero entries padded on never win (den 0)
    pad = -n % 8
    want = tb1.pk_select_reference(qe, qmk, torch.nn.functional.pad(pat, (0, 0, 0, pad)),
                                   torch.nn.functional.pad(msk, (0, 0, 0, pad)))
    assert torch.equal(got, want)
    assert torch.equal(got, tpm.match_packed_int8_pairs(q_enc, q_mask, *db))
    assert torch.equal(route, got)
    assert int(got[2, 0]) == a


def test_b1_select_refuses_other_queries(cuda):
    """pk_select and match_packed_small_b's group of one raise on a query
    that is not bit-valued (after the launch, which the counters show); the
    groups of 2 and 4 take any int8 query."""
    rng = np.random.default_rng(5)
    pat, msk = (torch.from_numpy(rng.integers(0, 256, (512, 1600), dtype=np.uint8)).to(cuda)
                for _ in range(2))
    qe = torch.from_numpy(rng.integers(-3, 4, (32, 12_800), dtype=np.int8)).to(cuda)
    qm = torch.from_numpy(rng.integers(0, 2, (32, 12_800), dtype=np.int8)).to(cuda)
    before = tb1.pk_select.launches, tpm.match_packed_small_b.launches
    with pytest.raises(ValueError, match="bit-valued"):
        tb1.pk_select(qe, qm, pat, msk)
    q_enc, q_mask = prepare_query_planes(pat[:5], msk[:5])
    q_enc[1, 3, :100] = q_enc[4, 3, :100] = 2
    db = (pat.view(1, 512, 1600), msk.view(1, 512, 1600))
    with pytest.raises(ValueError, match="bit-valued"):
        tpm.match_packed_small_b(q_enc, q_mask, *db)
    assert (tb1.pk_select.launches, tpm.match_packed_small_b.launches) == (before[0] + 1,
                                                                           before[1] + 2)
    assert torch.equal(tpm.match_packed_small_b(q_enc[:4], q_mask[:4], *db),
                       tpm.match_packed_small_b_reference(q_enc[:4], q_mask[:4], *db))


@pytest.mark.parametrize("n", PK_SELECT_N)
def test_pk_fractions_kernel(cuda, n):
    """fractions_packed_small_b at B = 1 (csrc/b1_packed.cu's
    pk_fractions_kernel) against its plain version, bit for bit, at one
    entry, the tile edges, the planted traps and past a wave of 132 blocks;
    the query's source entry a and its duplicate report the same pair."""
    pat, msk, qpat, qmsk, a = _pk_select_case(n)
    q_enc, q_mask = prepare_query_planes(*(torch.from_numpy(x).to(cuda) for x in (qpat, qmsk)))
    pat, msk = torch.from_numpy(pat).to(cuda), torch.from_numpy(msk).to(cuda)
    before = tb1.launch_fractions.launches, tpm.fractions_packed_small_b.launches
    got = tpm.fractions_packed_small_b(q_enc, q_mask, pat.view(1, n, 1600),
                                       msk.view(1, n, 1600))
    torch.cuda.synchronize()
    assert (tb1.launch_fractions.launches,
            tpm.fractions_packed_small_b.launches) == (before[0] + 1, before[1] + 1)
    # the plain version's int8 product on the card needs a multiple of 8 entries
    pad = -n % 8
    want = tpm.fractions_packed_small_b_reference(
        q_enc, q_mask, *(torch.nn.functional.pad(x, (0, 0, 0, pad)).view(1, n + pad, 1600)
                         for x in (pat, msk)))[:, :, :n]
    assert got.dtype == torch.int16 and got.shape == (2, 1, n) and torch.equal(got, want)
    if n == 700:
        assert got[0, 0, 129] == 0 and got[0, 0, 257] == 0 and not got[:, 0, 7].any()
    elif n > 256:
        assert torch.equal(got[:, 0, a], got[:, 0, a + 1]) and got[1, 0, a] > 0


def test_pk_fractions_refuses_other_queries(cuda):
    """fractions_packed_small_b's group of one raises on a query that is not
    bit-valued (after the launch, which the counter shows), at B = 1 and at
    B = 5; the group of 4 takes any int8 query."""
    rng = np.random.default_rng(6)
    pat, msk = (torch.from_numpy(rng.integers(0, 256, (512, 1600), dtype=np.uint8)).to(cuda)
                for _ in range(2))
    q_enc, q_mask = prepare_query_planes(pat[:5], msk[:5])
    q_enc[1, 3, :100] = q_enc[4, 3, :100] = 2
    db = (pat.view(1, 512, 1600), msk.view(1, 512, 1600))
    before = tb1.launch_fractions.launches
    for rows in (slice(4, 5), slice(0, 5)):
        with pytest.raises(ValueError, match="bit-valued"):
            tpm.fractions_packed_small_b(q_enc[rows], q_mask[rows], *db)
    assert tb1.launch_fractions.launches == before + 2
    assert torch.equal(tpm.fractions_packed_small_b(q_enc[:4], q_mask[:4], *db),
                       tpm.fractions_packed_small_b_reference(q_enc[:4], q_mask[:4], *db))


# pk_dot's tile edges (256 and 512 entries, one TMA box of 256 rows), a few
# tiles and more than one wave of the persistent grid, with an all-masked
# entry (den = 0) and an all-set one.
# The plain version runs on the DB padded to a multiple of 8 entries
# (torch._int_mm on the card).
@pytest.mark.parametrize("n", [1, 255, 256, 257, 511, 1500, 65_537])
def test_pk_dot_kernel_edges(cuda, n):
    rng = np.random.default_rng(n + 1)
    pat = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msk[0] = 0
    pat[-1] = msk[-1] = 255
    qp, qm = (torch.from_numpy(rng.integers(0, 256, (1, 1600), dtype=np.uint8)).to(cuda)
              for _ in range(2))
    qe, qmk = tb1.prep_query(qp, qm)
    pat, msk = torch.from_numpy(pat).to(cuda), torch.from_numpy(msk).to(cuda)
    pad = -n % 8
    want = tb1.pk_dot_reference(qe, qmk, torch.nn.functional.pad(pat, (0, 0, 0, pad)),
                                torch.nn.functional.pad(msk, (0, 0, 0, pad)))[:, :n]
    before = tb1.pk_dot.launches
    got = tb1.pk_dot(qe, qmk, pat, msk)
    torch.cuda.synchronize()
    assert tb1.pk_dot.launches == before + 1
    assert torch.equal(got, want)
    if n > 1:
        assert int((got[:, 0] >> 16).max()) == 0 and int((got[:31, -1] >> 16).min()) > 0


def test_pk_dot_refuses_other_queries(cuda):
    """pk_dot raises on a query that is not bit-valued (after its launch,
    which the counter shows), and takes the same DB with prep_query's pair."""
    rng = np.random.default_rng(3)
    pat, msk = (torch.from_numpy(rng.integers(0, 256, (256, 1600), dtype=np.uint8)).to(cuda)
                for _ in range(2))
    qe = torch.from_numpy(rng.integers(-3, 4, (32, 12_800), dtype=np.int8)).to(cuda)
    qm = torch.from_numpy(rng.integers(0, 2, (32, 12_800), dtype=np.int8)).to(cuda)
    before = tb1.pk_dot.launches
    with pytest.raises(ValueError):
        tb1.pk_dot(qe, qm, pat, msk)
    assert tb1.pk_dot.launches == before + 1
    qe, qm = tb1.prep_query(pat[:1], msk[:1])
    assert torch.equal(tb1.pk_dot(qe, qm, pat, msk), tb1.pk_dot_reference(qe, qm, pat, msk))


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
