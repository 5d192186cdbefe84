"""The port's CUDA kernels against their plain versions on the card, and the
engine on the card against the engine on the CPU.

Marked ``gpu``; each test skips where no CUDA card is present. This file
imports no jax, so on a card machine without jax it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from mpc_iris_tpu_torch.models import PlaintextEngine
from mpc_iris_tpu_torch.models.engines import _pad_chunks, prepare_query_planes
from mpc_iris_tpu_torch.ops import packed_match as tpm
from mpc_iris_tpu_torch.ops import select as tsel

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


@pytest.mark.parametrize("b,chunk", [(1, 304), (3, 1000), (8, 64)])
def test_match_packed_small_b_kernel(cuda, b, chunk):
    pat, msk, qpat, qmsk = tpm.planted_packed_case(np.random.default_rng(b), b=b)
    db_pat = torch.from_numpy(_pad_chunks(pat, chunk)[0]).to(cuda)
    db_msk = torch.from_numpy(_pad_chunks(msk, chunk)[0]).to(cuda)
    q_enc, q_mask = prepare_query_planes(torch.from_numpy(qpat).to(cuda),
                                         torch.from_numpy(qmsk).to(cuda))
    got = tpm.match_packed_small_b(q_enc, q_mask, db_pat, db_msk)
    torch.cuda.synchronize()
    # the plain version's int8 product on the card needs chunk % 8 == 0
    want = tpm.match_packed_small_b_reference(q_enc, q_mask, db_pat, db_msk)
    assert torch.equal(got, want)
    assert int(got[2, 0]) == 129


@pytest.mark.parametrize("b,chunk", [(1, 304), (3, 1000), (8, 200)])
def test_fractions_packed_small_b_kernel(cuda, b, chunk):
    """Ragged 64-entry tiles at every chunk; the padded tail reports (0, 0)."""
    pat, msk, qpat, qmsk = tpm.planted_packed_case(np.random.default_rng(b), b=b)
    db_pat = torch.from_numpy(_pad_chunks(pat, chunk)[0]).to(cuda)
    db_msk = torch.from_numpy(_pad_chunks(msk, chunk)[0]).to(cuda)
    q_enc, q_mask = prepare_query_planes(torch.from_numpy(qpat).to(cuda),
                                         torch.from_numpy(qmsk).to(cuda))
    before = tpm.fractions_packed_small_b.launches
    got = tpm.fractions_packed_small_b(q_enc, q_mask, db_pat, db_msk)
    torch.cuda.synchronize()
    assert tpm.fractions_packed_small_b.launches == before + 1
    want = tpm.fractions_packed_small_b_reference(q_enc, q_mask, db_pat, db_msk)
    assert got.dtype == torch.int16 and torch.equal(got, want)
    assert int(got[0, 0, 129]) == 0 and int(got[0, 0, 257]) == 0
    assert not got[:, :, 700:].any()


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
