"""The chunk scan under the engine: query preparation, the per-chunk unpack
and int8 products, and the fold of chunk winners over the DB
(counterparts of ``prepare_query_planes``, ``_unpack_encode_chunk`` and
``_match_scan_packed`` in ``mpc_iris_tpu/models/engines.py``).

They live below both ``models/engines.py`` and ``ops/packed_match.py``: the
packed scan with the plain selection is the one plain version of the packed
match, whichever side of the small-batch dispatch a batch is on. The
reference's ``lax.scan`` over chunks is a Python loop here.
"""

from __future__ import annotations

import torch

from mpc_iris_tpu.constants import BITS, COLS, N_ROTATIONS, ROWS
from mpc_iris_tpu_torch.ops.decode import chunk_winners, initial_state, running_min
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


def _scan(b: int, qe, qm, n_chunks: int, chunk: int, planes, select) -> torch.Tensor:
    """Fold ``select`` over the chunks: ``planes(c)`` gives chunk c's (enc,
    mask) int8 [c, K]; returns int32 [3, B] (numerator, denominator, index)."""
    state = initial_state(b, qe.device)
    for c in range(n_chunks):
        enc_c, mask_c = planes(c)
        winners = select(dot_bits_batch(qe, enc_c), dot_bits_batch(qm, mask_c),
                         c * chunk)
        state = running_min(state, *winners)
    return torch.stack(state)


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
