"""The chunk scans under the engine: query preparation, the per-chunk unpack
and int8 products, the fold of chunk winners over the DB, and the per-entry
fraction spectrum (counterparts of ``prepare_query_planes``,
``_unpack_encode_chunk``, ``_match_scan_packed``, ``_fractions_scan`` and
``_fractions_scan_packed`` in ``mpc_iris_tpu/models/engines.py``).

They live below both ``models/engines.py`` and ``ops/packed_match.py``: the
packed scans are the plain versions of the packed kernels (with the plain
selection, of the match; the spectrum scan, of the audit spectrum), whichever
side of the small-batch dispatch a batch is on. The reference's
``lax.scan`` over chunks is one Python loop here, :func:`_chunk_products`.
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
from mpc_iris_tpu_torch.ops.rotations import expand_rotations_flat
from mpc_iris_tpu_torch.ops.select import N_ROT_PAD, ROT_BITREV, select_chunk


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
    """The chunk loop of every scan: ``planes(c)`` gives chunk c's (enc, mask)
    int8 [c, K]; yields per chunk the int32 [rows, c] numerator-dot and
    denominator products of the query rows ``qe`` / ``qm`` with it."""
    for c in range(n_chunks):
        enc_c, mask_c = planes(c)
        yield dot_bits_batch(qe, enc_c), dot_bits_batch(qm, mask_c)


def _scan(b: int, qe, qm, n_chunks: int, chunk: int, planes, select) -> torch.Tensor:
    """Fold ``select`` over the chunks; returns int32 [3, B] (numerator,
    denominator, index)."""
    state = initial_state(b, qe.device)
    for c, (dot, den) in enumerate(_chunk_products(qe, qm, n_chunks, planes)):
        state = running_min(state, *select(dot, den, c * chunk))
    return torch.stack(state)


def _spectrum_scan(q_enc, q_mask, n_chunks: int, chunk: int, planes) -> torch.Tensor:
    """Per (query, entry) the min-over-31-rotations exact (numerator,
    denominator), earliest rotation on equal fractions: int16 [2, B, C*c].
    Both values are at most 12,800, so int16 holds them exactly and
    non-negative (the reference's uint16 values, in a type torch can compare
    and convert on every device)."""
    b = q_enc.shape[0]
    rows = (b * N_ROTATIONS, BITS)
    out = torch.empty((2, b, n_chunks * chunk), dtype=torch.int16, device=q_enc.device)
    products = _chunk_products(q_enc.reshape(rows), q_mask.reshape(rows), n_chunks, planes)
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
    return _spectrum_scan(q_enc, q_mask, db_enc.shape[0], db_enc.shape[1],
                          lambda c: (db_enc[c], db_mask[c]))


def _unpack_encode_chunk(pat_c: torch.Tensor, msk_c: torch.Tensor):
    """Packed uint8 [c, 1600] plane pair -> (enc, mask) int8 [c, 12800]."""
    m = unpack_bits(msk_c).to(torch.int8)
    return encode_grid_i8(unpack_bits(pat_c), m), m


def _match_scan_packed(q_enc, q_mask, db_pat, db_msk, *, fused: bool = True) -> torch.Tensor:
    """Min-distance search over a BIT-PACKED DB, uint8 [C, c, 1600] pattern
    and mask planes, unpacked and encoded per chunk on the device. ``fused``
    selects each chunk with ``select_chunk``, else with the plain selection;
    the results are identical."""
    b = q_enc.shape[0]
    if fused:
        qe, qm, select = _fused_rows(q_enc), _fused_rows(q_mask), select_chunk
    else:
        qe = q_enc.reshape(b * N_ROTATIONS, BITS)
        qm = q_mask.reshape(b * N_ROTATIONS, BITS)
        select = _plain_select
    return _scan(b, qe, qm, db_pat.shape[0], db_pat.shape[1],
                 lambda c: _unpack_encode_chunk(db_pat[c], db_msk[c]), select)


def _fractions_scan_packed(q_enc, q_mask, db_pat, db_msk) -> torch.Tensor:
    """:func:`_fractions_scan` over a BIT-PACKED DB, uint8 [C, c, 1600]
    planes unpacked and encoded per chunk on the device; the plain version
    of the packed audit-spectrum kernel."""
    return _spectrum_scan(q_enc, q_mask, db_pat.shape[0], db_pat.shape[1],
                          lambda c: _unpack_encode_chunk(db_pat[c], db_msk[c]))
