"""The chunk scans under the engine: query preparation, the per-chunk int8
products, the fold of chunk winners over the DB, and the per-entry fraction
spectrum (counterparts of ``prepare_query_planes``, ``_match_scan_packed``,
``_fractions_scan`` and ``_fractions_scan_packed`` in
``mpc_iris_tpu/models/engines.py``).

They live below both ``models/engines.py`` and ``ops/packed_match.py``: the
packed scans are the plain versions of the packed kernels (with the plain
selection, of the match; the spectrum scan, of the audit spectrum), whichever
side of the small-batch dispatch a batch is on. The reference's
``lax.scan`` over chunks is one Python loop here: :func:`_chunk_products`
over unpacked chunks (the dense scans, the plain packed versions), and
:func:`_packed_gemm_products` over packed ones, one ``packed_gemm`` launch a
chunk (the packed scans of the dispatch past the small batches).
"""

from __future__ import annotations

import torch

from mpc_iris_tpu_torch.constants import BITS, COLS, N_ROTATIONS, ROWS
from mpc_iris_tpu_torch.ops.decode import (
    chunk_winners,
    fraction_min_rotations,
    initial_state,
    running_min,
)
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch
from mpc_iris_tpu_torch.ops.encode import encode_grid_i8, unpack_bits
from mpc_iris_tpu_torch.ops.packed_gemm import _unpack_encode_chunk, packed_gemm, packed_query
from mpc_iris_tpu_torch.ops.rotations import expand_rotations_flat
from mpc_iris_tpu_torch.ops.select import N_ROT_PAD, ROT_BITREV, select_chunk
from mpc_iris_tpu_torch.utils.profiling import annotate, count


def prepare_query_planes(patterns_packed: torch.Tensor, masks_packed: torch.Tensor):
    """Packed query templates uint8 [B, 1600] -> (q_enc, q_mask) int8
    [B, 31, K]: the rotated ring encoding {-1, 0, 1} and the rotated mask."""
    p = unpack_bits(patterns_packed).reshape(-1, ROWS, COLS)
    m = unpack_bits(masks_packed).reshape(-1, ROWS, COLS)
    q_enc = expand_rotations_flat(encode_grid_i8(p, m))
    q_mask = expand_rotations_flat(m.to(torch.int8))
    return q_enc, q_mask


def _fused_rows(q: torch.Tensor) -> torch.Tensor:
    """[B, 31, K] -> [B*32, K]: a dummy all-zero row appended per query and
    the rows in ROT_BITREV order, the layout of ``select_chunk``."""
    b = q.shape[0]
    pad = q.new_zeros((b, N_ROT_PAD - N_ROTATIONS, BITS))
    rev = torch.as_tensor(ROT_BITREV, device=q.device)
    return torch.cat([q, pad], dim=1)[:, rev].reshape(b * N_ROT_PAD, BITS)


def _plain_select(dot, den, index_offset):
    return chunk_winners(dot, den, N_ROTATIONS, index_offset)


def _chunk_products(qe, qm, n_chunks: int, planes):
    """The chunk loop over unpacked chunks: ``planes(c)`` gives chunk c's
    (enc, mask) int8 [c, K]; yields per chunk the int32 [rows, c]
    numerator-dot and denominator products of the query rows ``qe`` / ``qm``
    with it."""
    for c in range(n_chunks):
        enc_c, mask_c = planes(c)
        yield dot_bits_batch(qe, enc_c), dot_bits_batch(qm, mask_c)


def _packed_gemm_products(qe, qm, db_pat, db_msk):
    """The chunk loop over a packed DB, uint8 [C, c, 1600] planes: the query
    rows prepared once (``packed_query``), then per chunk both products of
    one ``packed_gemm`` (the kernel on the card, its plain version on the
    CPU), as :func:`_chunk_products` yields them. Counts the chunks the
    kernel took (``iris.scan.packed_gemm_chunks``) once the scan ends."""
    with annotate("iris.query_prep"):
        query = packed_query(qe, qm)
    for c in range(db_pat.shape[0]):
        yield packed_gemm(query, db_pat[c], db_msk[c])
    count("iris.scan.packed_gemm_chunks", db_pat.shape[0] if query.operand is not None else 0)


def _scan(b: int, products, chunk: int, select, device) -> torch.Tensor:
    """Fold ``select`` over the chunks' ``products``; returns int32 [3, B]
    (numerator, denominator, index)."""
    state = initial_state(b, device)
    for c, (dot, den) in enumerate(products):
        state = running_min(state, *select(dot, den, c * chunk))
    return torch.stack(state)


def _spectrum_scan(b: int, products, n_chunks: int, chunk: int, device) -> torch.Tensor:
    """Per (query, entry) the min-over-31-rotations exact (numerator,
    denominator) from the chunks' ``products`` of the B x 31 query rows,
    earliest rotation on equal fractions: int16 [2, B, C*c]. Both values are
    at most 12,800, so int16 holds them exactly and non-negative (the
    reference's uint16 values, in a type torch can compare and convert on
    every device)."""
    out = torch.empty((2, b, n_chunks * chunk), dtype=torch.int16, device=device)
    for c, (dot, den) in enumerate(products):
        dot = dot.reshape(b, N_ROTATIONS, chunk)
        den = den.reshape(b, N_ROTATIONS, chunk)
        n, d, _ = fraction_min_rotations((den - dot) >> 1, den, axis=1)
        out[:, :, c * chunk:(c + 1) * chunk] = torch.stack([n, d])
    return out


def _fractions_scan(q_enc, q_mask, db_enc, db_mask) -> torch.Tensor:
    """The fraction spectrum over a dense DB, int8 [C, c, K] encodings and
    masks: int16 [2, B, C*c] (see :func:`_spectrum_scan`); padded rows
    report d = 0."""
    b, (n_chunks, chunk) = q_enc.shape[0], db_enc.shape[:2]
    products = _chunk_products(_query_rows(q_enc), _query_rows(q_mask), n_chunks,
                               lambda c: (db_enc[c], db_mask[c]))
    return _spectrum_scan(b, products, n_chunks, chunk, q_enc.device)


def _query_rows(q: torch.Tensor) -> torch.Tensor:
    """[B, 31, K] -> [B*31, K]."""
    return q.reshape(q.shape[0] * N_ROTATIONS, BITS)


def _packed_products(qe, qm, db_pat, db_msk, fused: bool):
    """The chunk products over a packed DB: through ``packed_gemm``
    (``fused``) or each chunk unpacked and encoded, then two
    ``dot_bits_batch`` (the plain versions' path); identical values."""
    if fused:
        return _packed_gemm_products(qe, qm, db_pat, db_msk)
    return _chunk_products(qe, qm, db_pat.shape[0],
                           lambda c: _unpack_encode_chunk(db_pat[c], db_msk[c]))


def _match_scan_packed(q_enc, q_mask, db_pat, db_msk, *, fused: bool) -> torch.Tensor:
    """Min-distance search over a BIT-PACKED DB, uint8 [C, c, 1600] pattern
    and mask planes. ``fused`` takes each chunk's products in one
    ``packed_gemm`` and selects with ``select_chunk`` (the kernels on the
    card); else the chunk is unpacked and encoded on the device, its
    products are two ``dot_bits_batch`` and the selection is the plain one.
    The results are identical."""
    b = q_enc.shape[0]
    if fused:
        qe, qm, select = _fused_rows(q_enc), _fused_rows(q_mask), select_chunk
    else:
        qe, qm, select = _query_rows(q_enc), _query_rows(q_mask), _plain_select
    return _scan(b, _packed_products(qe, qm, db_pat, db_msk, fused), db_pat.shape[1],
                 select, q_enc.device)


def _fractions_scan_packed(q_enc, q_mask, db_pat, db_msk, *, fused: bool) -> torch.Tensor:
    """:func:`_fractions_scan` over a BIT-PACKED DB, uint8 [C, c, 1600]
    planes: ``fused`` takes each chunk's products in one ``packed_gemm``,
    else (the plain version of the packed audit-spectrum kernels) the chunk
    unpacked and encoded on the device and two ``dot_bits_batch``."""
    b, (n_chunks, chunk) = q_enc.shape[0], db_pat.shape[:2]
    products = _packed_products(_query_rows(q_enc), _query_rows(q_mask), db_pat, db_msk, fused)
    return _spectrum_scan(b, products, n_chunks, chunk, q_enc.device)
