"""The scan's packed products (``mpc_iris_tpu_torch.ops.packed_gemm``; its
plain version on the CPU): against the unpack and the two ``dot_bits_batch``
products and an int64 oracle; the kernel's K order and packed-word
expansion emulated on the CPU; the dispatchers past the small batches
(B = 9, 13, 33) against the port's plain paths and the JAX packed scans; the
wrapper's argument checks; the chunk counter. Exact: integers equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_iris_tpu.models import engines as jeng
from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES
from mpc_iris_tpu_torch.models import engines as teng
from mpc_iris_tpu_torch.ops import packed_gemm as pg
from mpc_iris_tpu_torch.ops import packed_match as tpm
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch
from mpc_iris_tpu_torch.ops.encode import encode_grid_i8, unpack_bits
from mpc_iris_tpu_torch.ops.scan import _fused_rows, prepare_query_planes
from mpc_iris_tpu_torch.utils import profiling

LSB = np.uint32(0x01010101)


def _case(b: int, n: int, chunk: int, seed: int):
    """planted_packed_case (rotation and index ties, duplicates at 129 and
    257, an all-invalid entry 7, a query sharing no valid bit) padded to
    chunks of ``chunk`` with all-zero entries; the numpy arrays beside."""
    pat, msk, qpat, qmsk = tpm.planted_packed_case(np.random.default_rng(seed), n=n, b=b)
    db_pat = torch.from_numpy(teng._pad_chunks(pat, chunk)[0])
    db_msk = torch.from_numpy(teng._pad_chunks(msk, chunk)[0])
    q_enc, q_mask = prepare_query_planes(torch.from_numpy(qpat), torch.from_numpy(qmsk))
    return q_enc, q_mask, db_pat, db_msk, (pat, msk, qpat, qmsk)


def _rows(kind: str, q: torch.Tensor) -> torch.Tensor:
    """The scan's query rows: the match's 32 a query in the selection's
    order (a zero pad row each), or the spectrum's 31."""
    return _fused_rows(q) if kind == "match" else q.reshape(-1, BITS)


# M = 9 x 32 and 128 x 32 (match rows), 13 x 31 (spectrum rows); every
# last chunk ragged: 700 entries in chunks of 304 (912), 300 in 128 (384)
ROW_CASES = [("match", 9, 700, 304), ("spectrum", 13, 700, 304), ("match", 128, 300, 128)]


@pytest.mark.parametrize("kind,b,n,chunk", ROW_CASES)
def test_plain_version_is_the_unpack_and_two_int8_products(kind, b, n, chunk):
    q_enc, q_mask, db_pat, db_msk, _ = _case(b, n, chunk, seed=b)
    qe, qm = _rows(kind, q_enc), _rows(kind, q_mask)
    query = pg.packed_query(qe, qm)
    assert query.operand is None  # the kernel operand is made on the card only
    for c in range(db_pat.shape[0]):
        dot, den = pg.packed_gemm(query, db_pat[c], db_msk[c])
        m = unpack_bits(db_msk[c]).to(torch.int8)
        enc = encode_grid_i8(unpack_bits(db_pat[c]), m)
        assert dot.dtype == den.dtype == torch.int32
        assert torch.equal(dot, dot_bits_batch(qe, enc))
        assert torch.equal(den, dot_bits_batch(qm, m))
        rows = slice(0, 40)  # an int64 oracle on the first rows
        np.testing.assert_array_equal(
            dot[rows].numpy(), qe[rows].numpy().astype(np.int64) @ enc.numpy().astype(np.int64).T)
        np.testing.assert_array_equal(
            den[rows].numpy(), qm[rows].numpy().astype(np.int64) @ m.numpy().astype(np.int64).T)
    valid = n - (db_pat.shape[0] - 1) * chunk
    assert not den[:, valid:].any() and not dot[:, valid:].any()  # padded entries: d = 0


def test_an_empty_batch_gives_empty_products():
    """No query rows (an empty batch reaching the scan) on the CPU: empty
    products, as the unpack and ``dot_bits_batch`` give."""
    q = torch.zeros((0, BITS), dtype=torch.int8)
    pat = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (40, BITS_BYTES),
                                                             dtype=np.uint8))
    dot, den = pg.packed_gemm(pg.packed_query(q, q), pat, pat)
    assert dot.shape == den.shape == (0, 40)


def _kernel_db_operand(pat: np.ndarray, msk: np.ndarray):
    """The kernel's DB side, emulated from the packed uint32 words as its
    consumer threads expand them: K position 256 s + 32 b + l of an entry is
    bit b of packed byte 32 s + l; mask (w_m >> b) & 0x01010101, encoding
    ((w_p & w_m) >> b & 0x01010101) * 0xFE + mask. Returns (enc, mask) int8
    [n, 12800] in the kernel's K order."""
    wp = pat.view(np.uint32).reshape(-1, BITS_BYTES // pg.SLAB, 1, pg.SLAB // 4)
    wm = msk.view(np.uint32).reshape(-1, BITS_BYTES // pg.SLAB, 1, pg.SLAB // 4)
    b = np.arange(8, dtype=np.uint32).reshape(1, 1, 8, 1)
    am = (wm >> b) & LSB
    ae = (((wp & wm) >> b) & LSB) * np.uint32(0xFE) + am
    return (ae.astype(np.uint32).view(np.int8).reshape(-1, BITS),
            am.astype(np.uint32).view(np.int8).reshape(-1, BITS))


def test_kernel_k_order_and_expansion():
    """Query rows permuted into kernel_k_order against the emulated packed
    expansion give both products exactly: the order is a permutation of K
    in which one K-step of 32 is one bit-plane of one 32-byte slab."""
    order = pg.kernel_k_order()
    assert sorted(order.tolist()) == list(range(BITS))
    assert (order.reshape(-1, pg.SLAB) % 8 == order.reshape(-1, pg.SLAB)[:, :1] % 8).all()
    q_enc, q_mask, _, _, (pat, msk, _, _) = _case(9, 700, 700, seed=5)
    qe, qm = _fused_rows(q_enc), _fused_rows(q_mask)
    enc_k, mask_k = _kernel_db_operand(pat, msk)
    idx = torch.from_numpy(order)
    dot = dot_bits_batch(qe[:, idx].contiguous(), torch.from_numpy(enc_k))
    den = dot_bits_batch(qm[:, idx].contiguous(), torch.from_numpy(mask_k))
    want = pg.packed_gemm(pg.packed_query(qe, qm), torch.from_numpy(pat), torch.from_numpy(msk))
    assert torch.equal(dot, want[0]) and torch.equal(den, want[1])


@pytest.mark.parametrize("m,n", [(288, 304), (403, 1000), (4096, 16384), (1, 1)])
def test_plan_covers_every_tile(m, n):
    plan = pg.packed_gemm_plan(m, n)
    assert plan.query_tiles * pg.QUERY_TILE >= m > (plan.query_tiles - 1) * pg.QUERY_TILE
    assert plan.db_tiles * pg.DB_TILE >= n > (plan.db_tiles - 1) * pg.DB_TILE
    assert 1 <= plan.grid <= min(plan.tiles, pg.H100_SMS)
    assert plan.group == min(pg.GROUP, 2 * plan.query_tiles)


def _jax_planes(qpat, qmsk, pat, msk, chunk):
    q_enc, q_mask = jeng.prepare_query_planes(qpat, qmsk)
    return (q_enc, q_mask, jnp.asarray(jeng._pad_chunks(pat, chunk)[0]),
            jnp.asarray(jeng._pad_chunks(msk, chunk)[0]))


@pytest.mark.parametrize("b", [9, 13, 33])
def test_match_dispatch_past_the_small_batches(b):
    """match_scan_packed_auto at B > 8 (packed_gemm and select_chunk) gives
    the winners of the plain packed path and the JAX packed scan."""
    q_enc, q_mask, db_pat, db_msk, (pat, msk, qpat, qmsk) = _case(b, 700, 304, seed=b)
    got = teng.match_scan_packed_auto(q_enc, q_mask, db_pat, db_msk)
    assert torch.equal(got, tpm.match_packed_small_b_reference(q_enc, q_mask, db_pat, db_msk))
    want = jeng._match_scan_packed(*_jax_planes(qpat, qmsk, pat, msk, 304), fused=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2, 0] == 129 and got[0, 0] == 0  # the self-match, lower index of the pair


@pytest.mark.parametrize("b", [9, 13, 33])
def test_spectrum_dispatch_past_the_small_batches(b):
    """fractions_scan_packed_auto at B > 8 gives the plain packed spectrum
    and the JAX packed spectrum scan's, padded entries (0, 0)."""
    q_enc, q_mask, db_pat, db_msk, (pat, msk, qpat, qmsk) = _case(b, 700, 304, seed=100 + b)
    got = teng.fractions_scan_packed_auto(q_enc, q_mask, db_pat, db_msk)
    assert torch.equal(got, tpm.fractions_packed_small_b_reference(q_enc, q_mask, db_pat, db_msk))
    want = jeng._fractions_scan_packed(*_jax_planes(qpat, qmsk, pat, msk, 304))
    np.testing.assert_array_equal(got.numpy().astype(np.uint16), np.asarray(want))
    assert not got[:, :, 700:].any() and got[0, 0, 129] == 0 and got[0, 0, 257] == 0


def _bad_args():
    q = torch.zeros((64, BITS), dtype=torch.int8)
    query = pg.packed_query(q, q)
    pat = torch.zeros((8, BITS_BYTES), dtype=torch.uint8)
    wide = torch.zeros((8, 2 * BITS_BYTES), dtype=torch.uint8)
    meta = torch.empty((8, BITS_BYTES), dtype=torch.uint8, device="meta")
    return {
        "pat dtype": (TypeError, lambda: pg.packed_gemm(query, pat.to(torch.int16), pat)),
        "msk dtype": (TypeError, lambda: pg.packed_gemm(query, pat, pat.view(torch.int8))),
        "query dtype": (TypeError, lambda: pg.packed_query(q.to(torch.int32), q.to(torch.int32))),
        "query kind": (TypeError, lambda: pg.packed_gemm((q, q, None), pat, pat)),
        "pat width": (ValueError, lambda: pg.packed_gemm(query, pat[:, :-1], pat[:, :-1])),
        "pat rank": (ValueError, lambda: pg.packed_gemm(query, pat[None], pat[None])),
        "shapes differ": (ValueError, lambda: pg.packed_gemm(query, pat, pat[:4])),
        "no entries": (ValueError, lambda: pg.packed_gemm(query, pat[:0], pat[:0])),
        "query width": (ValueError, lambda: pg.packed_query(q[:, :-8], q[:, :-8])),
        "query shapes": (ValueError, lambda: pg.packed_query(q, q[:32])),
        "devices": (ValueError, lambda: pg.packed_gemm(query, meta, meta)),
        "device kind": (ValueError, lambda: pg.packed_gemm(
            pg.packed_query(q.to("meta"), q.to("meta")), meta, meta)),
        "contiguity": (ValueError, lambda: pg.packed_gemm(query, wide[:, :BITS_BYTES],
                                                          wide[:, BITS_BYTES:])),
    }


@pytest.mark.parametrize("what", list(_bad_args()))
def test_wrapper_refuses(what):
    err, call = _bad_args()[what]
    with pytest.raises(err):
        call()


def test_chunk_counter_under_a_capture():
    """``iris.scan.packed_gemm_chunks`` is made by the dispatch's scan under a
    capture and counts the chunks the kernel took: none on the CPU, where
    the wrapper runs its plain version; the plain paths never touch it."""
    q_enc, q_mask, db_pat, db_msk, _ = _case(9, 700, 304, seed=9)
    name = "iris.scan.packed_gemm_chunks"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        before = profiling.snapshot()["counters"].get(name)
        tpm.match_packed_small_b_reference(q_enc, q_mask, db_pat, db_msk)
        tpm.fractions_packed_small_b_reference(q_enc, q_mask, db_pat, db_msk)
        assert profiling.snapshot()["counters"].get(name) == before
        teng.match_scan_packed_auto(q_enc, q_mask, db_pat, db_msk)
        teng.fractions_scan_packed_auto(q_enc, q_mask, db_pat, db_msk)
        assert profiling.snapshot()["counters"][name] == (before or 0)
