"""Ring encoding and packed-bit <-> unpacked conversions on tensors
(counterpart of ``mpc_iris_tpu/ops/encode.py``).

Torch has no uint16 add, shift or compare on the CPU, so the u16 ring encoding
and the share split compute in int32 with ``& 0xFFFF``: a u16 value on the
device is an int32 in [0, 2^16), and the host edge turns it into ``np.uint16``.
The per-template host functions at the end (``encode_template``,
``decode_encoded``, ``template_grids``) are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_iris_tpu_torch.constants import BITS
from mpc_iris_tpu_torch.ops.chacha import k_permutation, key_tensor, share_planes_kernel
from mpc_iris_tpu_torch.types import Bits, EncodedBits, Template


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


def encode_grid_u16(pattern_bits: torch.Tensor, mask_bits: torch.Tensor) -> torch.Tensor:
    """u16 ring encoding ``mask - 2 * (pattern & mask)`` mod 2^16, as int32
    in [0, 2^16): {0, 1, 0xFFFF} = {masked, unset, set} (mirrors
    ``encode.encode_grid_u16``)."""
    p = pattern_bits.to(torch.int32)
    m = mask_bits.to(torch.int32)
    return (m - 2 * (p & m)) & 0xFFFF


def _share_split_chunk(p: torch.Tensor, m: torch.Tensor, kw: torch.Tensor,
                       row0: int, n_shares: int, inv: torch.Tensor) -> torch.Tensor:
    """One chunk of :func:`share_split_device` on ``kw``'s device: packed
    uint8 [c, 1600] planes -> int32 [n_shares, c, 12800] u16 shares. The
    keystream shares come from ``chacha.share_planes_kernel`` (the kernel on
    the card) as natural-order planes, rebuilt into u16 rows in file order
    by ``inv``, the inverse of ``chacha.k_permutation``."""
    enc = encode_grid_u16(unpack_bits(p), unpack_bits(m))
    out = torch.empty((n_shares, *enc.shape), dtype=torch.int32, device=p.device)
    total = enc
    for s in range(n_shares - 1):
        lo, hi = share_planes_kernel(kw, s, row0, p.shape[0])
        natural = (lo.to(torch.int32) + 128) | ((hi.to(torch.int32) + 128) << 8)
        out[s] = natural[:, inv]
        total = (total - out[s]) & 0xFFFF  # wrapping u16 difference
    out[n_shares - 1] = total
    return out


def share_split_device(patterns_packed, masks_packed, n_shares: int, key,
                       row_offset: int = 0, *, device, chunk: int = 16384,
                       shares=None) -> np.ndarray:
    """Device-side prepare: packed planes -> additive Z_2^16 shares, byte-
    identical to ``native.share_split`` with the same key (mirrors
    ``encode.share_split_device``): shares s < n_shares-1 are the ChaCha20
    streams (key, s, row), the last is the encoding minus their sum.

    Works ``chunk`` rows at a time on ``device`` and writes into a host
    array, so the device never holds more than one chunk's shares.

    Args:
      patterns_packed, masks_packed: uint8 [N, 1600] packed planes (host).
      key: 32-byte ChaCha20 key.
      row_offset: global DB row of the first template; every chunk's first
        row must be below 2^32 (its rows may cross it: the nonce carry).
      shares: which of the n_shares to return (default all), e.g. only the
        data-carrying last one.

    Returns np.uint16 [len(shares), N, 12800] (host).
    """
    if n_shares < 2:
        raise ValueError("share_split needs at least 2 shares")
    keep = list(range(n_shares)) if shares is None else [int(s) for s in shares]
    pat = np.ascontiguousarray(patterns_packed, dtype=np.uint8)
    msk = np.ascontiguousarray(masks_packed, dtype=np.uint8)
    n = pat.shape[0]
    kw = key_tensor(key, device)
    inv = torch.from_numpy(np.argsort(k_permutation())).to(device)
    out = np.empty((len(keep), n, BITS), dtype=np.uint16)
    for start in range(0, n, chunk):
        end = min(n, start + chunk)
        sh = _share_split_chunk(torch.from_numpy(pat[start:end]).to(device),
                                torch.from_numpy(msk[start:end]).to(device),
                                kw, row_offset + start, n_shares, inv)
        # int32 in [0, 2^16) -> int16 bit patterns, copied straight into the
        # output: half the bytes of int32, and no second host copy
        for i, s in enumerate(keep):
            torch.from_numpy(out[i, start:end].view(np.int16)).copy_(sh[s])
    return out


def encode_template(template: Template) -> EncodedBits:
    """Host oracle: a Template's u16 ring vector ``mask - 2 * (pattern & mask)``,
    wrapping (reference ``encode``, src/lib.rs:16-26; copy of
    ``encode.encode_template``)."""
    p = np.unpackbits(template.pattern.data, bitorder="little").astype(np.uint16)
    m = np.unpackbits(template.mask.data, bitorder="little").astype(np.uint16)
    return EncodedBits(m - np.uint16(2) * (p & m))


def decode_encoded(enc: EncodedBits) -> Template:
    """Invert :func:`encode_template`: mask bit = ``enc != 0``, pattern bit =
    ``enc == 0xFFFF`` (copy of ``encode.decode_encoded``). Pattern bits under
    a zero mask are lost in the encoding and decode to 0."""
    e = enc.data
    return Template(Bits(np.packbits(e == 0xFFFF, bitorder="little")),
                    Bits(np.packbits(e != 0, bitorder="little")))


def template_grids(template: Template, device=None):
    """(pattern, mask) as {0,1} uint8 [64, 200] grids: numpy arrays, or
    tensors on ``device`` when one is given (the counterpart of
    ``encode.template_grids``'s ``xp``)."""
    p = template.pattern.grid().astype(np.uint8)
    m = template.mask.grid().astype(np.uint8)
    if device is not None:
        return torch.from_numpy(p).to(device), torch.from_numpy(m).to(device)
    return p, m
