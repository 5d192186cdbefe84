"""Plain reference of a keyed MPC party: its share rows from the 32-byte key,
and its reply, the u16 dot shares of the rotated encoded queries.

Share stream s of DB row R is the ChaCha20 keystream (RFC 8439) under the key
with counter 0.. and nonce words [s, R mod 2^32, R >> 32], read as 12,800
little-endian u16 values (docs/SPEC.md section 4.1). The reply of entry e to
query q at rotation r is sum_k enc(rot_r(q))[k] * share_e[k] mod 2^16, with
enc = m - 2 (p & m) (+1 unset, -1 set, 0 masked; upstream src/lib.rs:16-26,
134-163), laid out [entry, query, rotation] (the batched wire). The sums
reach 12,800 * 65,535 < 2^53, so float64 products are exact. (float32 ones
are exact too on most random inputs, whose sums stay under 2^24; the
control therefore takes the shares at 8 bits, the integer precision below
the configuration's 16.) Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.data import BITS
from benchmark.reference.plaintext import query_rows

_CONSTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
BLOCKS_PER_ROW = 2 * BITS // 64


def _rotl(x: np.ndarray, k: int) -> np.ndarray:
    return (x << np.uint32(k)) | (x >> np.uint32(32 - k))


def _quarter(s, a, b, c, d):
    s[a] += s[b]; s[d] ^= s[a]; s[d] = _rotl(s[d], 16)  # noqa: E702
    s[c] += s[d]; s[b] ^= s[c]; s[b] = _rotl(s[b], 12)  # noqa: E702
    s[a] += s[b]; s[d] ^= s[a]; s[d] = _rotl(s[d], 8)  # noqa: E702
    s[c] += s[d]; s[b] ^= s[c]; s[b] = _rotl(s[b], 7)  # noqa: E702


def share_rows(key: bytes, stream_id: int, rows: np.ndarray) -> np.ndarray:
    """uint16 [len(rows), 12800]: rows ``rows`` of share stream
    ``stream_id`` under ``key``."""
    rows = np.asarray(rows, dtype=np.uint64)
    shape = (rows.size, BLOCKS_PER_ROW)
    kw = np.frombuffer(bytes(key), dtype="<u4")
    if kw.size != 8:
        raise ValueError("a ChaCha20 key is 32 bytes")

    def full(v):
        return np.full(shape, v, dtype=np.uint32)

    init = [full(c) for c in _CONSTS] + [full(w) for w in kw]
    init.append(np.broadcast_to(np.arange(BLOCKS_PER_ROW, dtype=np.uint32), shape).copy())
    init.append(full(stream_id))
    init.append(np.broadcast_to((rows & np.uint64(0xFFFFFFFF)).astype(np.uint32)[:, None],
                                shape).copy())
    init.append(np.broadcast_to((rows >> np.uint64(32)).astype(np.uint32)[:, None],
                                shape).copy())
    x = [w.copy() for w in init]
    for _ in range(10):
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    words = np.stack([a + b for a, b in zip(x, init)], axis=-1)  # [R, 400, 16]
    return words.astype("<u4").view("<u2").reshape(rows.size, BITS)


def quantized(share: np.ndarray, bits: int) -> np.ndarray:
    """Share rows held at ``bits`` bits of precision (rounded to the nearest
    multiple of 2^(16 - bits), mod 2^16): the control's lower precision."""
    step = 1 << (16 - bits)
    return ((share.astype(np.int64) + step // 2) // step * step & 0xFFFF).astype(np.uint16)


def reply(share: np.ndarray, pat: np.ndarray, msk: np.ndarray, device) -> np.ndarray:
    """uint16 [R, Q, 31]: the reply at share rows uint16 [R, 12800] to the
    packed queries uint8 [Q, 1600]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    enc, _ = query_rows(pat, msk, device)
    s = torch.from_numpy(share.astype(np.float64)).to(device)
    dots = enc.double() @ s.T  # [Q * 31, R], exact
    wrapped = torch.remainder(dots.round().to(torch.int64), 1 << 16)
    return wrapped.reshape(pat.shape[0], 31, -1).permute(2, 0, 1).cpu().numpy().astype(np.uint16)
