"""Ring encoding and packed-bit <-> unpacked conversions on tensors
(counterpart of ``mpc_iris_tpu/ops/encode.py``).

Only the uint8 / int8 forms the plaintext path needs live here; the u16 ring
encoding belongs to the share path.
"""

from __future__ import annotations

import torch


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Unpack uint8 [..., n_bytes] -> uint8 {0,1} [..., 8*n_bytes], LSB-first
    (bit i at byte i//8, position i%8; mirrors ``encode.unpack_bits``)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.to(torch.uint8).unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack {0,1} [..., 8*n] -> uint8 [..., n], LSB-first (inverse of
    :func:`unpack_bits`; mirrors ``encode.pack_bits``)."""
    n = bits.shape[-1]
    if n % 8:
        raise ValueError("bit count must be a multiple of 8")
    grouped = bits.to(torch.int32).reshape(*bits.shape[:-1], n // 8, 8)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    # A sum of distinct powers of two fits uint8 exactly.
    return (grouped * weights).sum(dim=-1).to(torch.uint8)


def encode_grid_i8(pattern_bits: torch.Tensor, mask_bits: torch.Tensor) -> torch.Tensor:
    """Signed int8 ring encoding {-1, 0, +1} = {set, masked, unset}:
    ``mask - 2 * (pattern & mask)`` (mirrors ``encode.encode_grid_i8``)."""
    p = pattern_bits.to(torch.int8)
    m = mask_bits.to(torch.int8)
    return m - 2 * (p & m)
