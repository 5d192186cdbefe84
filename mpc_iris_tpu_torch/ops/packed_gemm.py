"""Both int8 products of the scan over one bit-packed DB chunk in one Hopper
kernel (products (e); the TPU package computes them with XLA in
``mpc_iris_tpu/models/engines.py::_match_scan_packed``: ``_unpack_encode_chunk``,
then ``dot_bits_batch_i4`` twice).

:func:`packed_gemm` launches ``csrc/packed_gemm.cu`` for CUDA tensors: it
reads the chunk's packed pattern and mask planes, expands them in the kernel
and never writes them out unpacked. CPU tensors take the plain version
:func:`packed_gemm_reference`: the chunk unpacked and encoded
(:func:`_unpack_encode_chunk`), then the two products of ``dot_bits_batch``.
The query rows are prepared once a request by :func:`packed_query`, which
also permutes them into the kernel's K order (:func:`kernel_k_order`) on the
card. :func:`packed_gemm_plan` picks the kernel's persistent grid and walk.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES
from mpc_iris_tpu_torch.ops._build import check_launch, library
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch
from mpc_iris_tpu_torch.ops.encode import encode_grid_i8, unpack_bits

SLAB = 32           # packed bytes of an entry a kernel stage: 8 bit-planes of 32 K
QUERY_TILE = 256    # query rows a tile (the wgmma N)
DB_TILE = 128       # DB rows a tile: two consumer warpgroups x 64
GROUP = 2           # query tiles a group of the kernel's walk (1, 2, 4, 8 timed within 1%)
H100_SMS = 132


def _unpack_encode_chunk(pat_c: torch.Tensor, msk_c: torch.Tensor):
    """Packed uint8 [c, 1600] plane pair -> (enc, mask) int8 [c, 12800]."""
    m = unpack_bits(msk_c).to(torch.int8)
    return encode_grid_i8(unpack_bits(pat_c), m), m


@functools.cache
def kernel_k_order() -> np.ndarray:
    """The kernel's K order: position p = 256 s + 32 b + l holds the natural
    K index 8 (32 s + l) + b, bit b of packed byte 32 s + l. So a K-step of
    32 is one bit-plane of one 32-byte slab of packed bytes, and the 256 K of
    a stage are the slab's 8 bit-planes."""
    p = np.arange(BITS)
    s, b, lane = p // (8 * SLAB), p // SLAB % 8, p % SLAB
    return 8 * (SLAB * s + lane) + b


@functools.cache
def _k_order_index(device: torch.device) -> torch.Tensor:
    """:func:`kernel_k_order` on ``device``, uploaded once."""
    return torch.as_tensor(kernel_k_order(), device=device)


class PackedQuery(NamedTuple):
    """The query rows of a packed scan, prepared once a request: int8 [M, K]
    rows against the encoding (``enc``) and the mask (``mask``), natural K
    order; on the card also ``operand``, both in the kernel's K order, int8
    [2M, K] (``enc`` rows, then ``mask`` rows)."""

    enc: torch.Tensor
    mask: torch.Tensor
    operand: torch.Tensor | None


def packed_query(q_enc: torch.Tensor, q_mask: torch.Tensor) -> PackedQuery:
    """int8 [M, 12800] rows x2 (natural K order) -> :class:`PackedQuery`;
    on the card one gather puts both into the kernel's K order."""
    if q_enc.dim() != 2 or q_enc.shape[1] != BITS or q_mask.shape != q_enc.shape:
        raise ValueError(f"packed_query: q_enc and q_mask must be [M, {BITS}] of one shape")
    if q_enc.dtype != torch.int8 or q_mask.dtype != torch.int8:
        raise TypeError("packed_query: q_enc and q_mask must be int8")
    if q_enc.device != q_mask.device:
        raise ValueError("packed_query: tensors on different devices")
    operand = None
    if q_enc.device.type == "cuda":
        operand = torch.cat([q_enc, q_mask])[:, _k_order_index(q_enc.device)]
    return PackedQuery(q_enc, q_mask, operand)


def packed_gemm_reference(query: PackedQuery, pat: torch.Tensor, msk: torch.Tensor):
    """Plain version of :func:`packed_gemm`: the chunk unpacked and encoded,
    then the two int8 products."""
    enc, m = _unpack_encode_chunk(pat, msk)
    return dot_bits_batch(query.enc, enc), dot_bits_batch(query.mask, m)


@dataclass(frozen=True)
class PackedGemmPlan:
    """How :func:`packed_gemm` covers M query rows x N entries: tiles of
    :data:`QUERY_TILE` query rows x :data:`DB_TILE` entries of one product,
    walked in groups of ``group`` query tiles by ``grid`` persistent blocks
    (one an SM)."""

    query_tiles: int
    db_tiles: int
    group: int
    grid: int

    @property
    def tiles(self) -> int:
        return 2 * self.query_tiles * self.db_tiles


def packed_gemm_plan(m: int, n: int, sms: int = H100_SMS) -> PackedGemmPlan:
    """The kernel's plan for M query rows (each product) and N entries on
    ``sms`` SMs: a persistent grid of at most one block an SM."""
    q_tiles, db_tiles = -(-m // QUERY_TILE), -(-n // DB_TILE)
    return PackedGemmPlan(q_tiles, db_tiles, min(GROUP, 2 * q_tiles),
                          min(2 * q_tiles * db_tiles, sms))


def _check_chunk(query: PackedQuery, pat: torch.Tensor, msk: torch.Tensor) -> None:
    if not isinstance(query, PackedQuery):
        raise TypeError("packed_gemm: query must come from packed_query")
    if pat.dim() != 2 or pat.shape[1] != BITS_BYTES or msk.shape != pat.shape or pat.shape[0] < 1:
        raise ValueError(f"packed_gemm: pat and msk must be [c, {BITS_BYTES}] of one shape")
    if pat.dtype != torch.uint8 or msk.dtype != torch.uint8:
        raise TypeError("packed_gemm: pat and msk must be uint8")
    if not (pat.is_contiguous() and msk.is_contiguous()):
        raise ValueError("packed_gemm: pat and msk must be contiguous")
    if len({query.enc.device, pat.device, msk.device}) != 1:
        raise ValueError("packed_gemm: tensors on different devices")


def packed_gemm(query: PackedQuery, pat: torch.Tensor, msk: torch.Tensor):
    """The chunk's numerator-dot and denominator products: int32 [M, c]
    ``query.enc @ enc^T`` and ``query.mask @ mask^T`` for the ring encoding
    and mask of the packed planes ``pat``, ``msk`` (uint8 [c, 1600],
    contiguous). One launch of ``csrc/packed_gemm.cu`` for CUDA tensors;
    CPU tensors take the plain version."""
    _check_chunk(query, pat, msk)
    if pat.device.type == "cpu":
        return packed_gemm_reference(query, pat, msk)
    if pat.device.type != "cuda" or query.operand is None:
        raise ValueError(f"packed_gemm: unsupported device {pat.device}")
    out = _launch(query.operand, pat, msk)
    packed_gemm.launches += 1
    return out[0], out[1]


packed_gemm.launches = 0


def _launch(operand: torch.Tensor, pat: torch.Tensor, msk: torch.Tensor) -> torch.Tensor:
    """One launch on the current stream: int32 [2, M, c] (dot, den)."""
    m, n = operand.shape[0] // 2, pat.shape[0]
    if not (operand.is_contiguous() and operand.data_ptr() % 16 == 0):
        raise ValueError("packed_gemm: the query operand must be contiguous and 16-byte aligned")
    if pat.data_ptr() % 16 or msk.data_ptr() % 16:
        raise ValueError("packed_gemm: pat and msk must be 16-byte aligned (TMA)")
    if not (1 <= m and 2 * m < 2**31 and 1 <= n < 2**31):
        raise ValueError(f"packed_gemm: unsupported M={m} c={n}")
    sms = torch.cuda.get_device_properties(pat.device).multi_processor_count
    plan = packed_gemm_plan(m, n, sms)
    out = torch.empty((2, m, n), dtype=torch.int32, device=pat.device)
    lib = library()
    with torch.cuda.device(pat.device):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch("packed_gemm", lib.packed_gemm_launch(
            plan.grid, plan.group, operand.data_ptr(), pat.data_ptr(),
            msk.data_ptr(), m, n, out.data_ptr(), stream))
    return out
