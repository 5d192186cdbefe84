"""ChaCha20 (RFC 8439) share-stream regeneration on tensors (counterpart of
``mpc_iris_tpu/ops/chacha.py``).

``prepare`` derives every share s < n-1 of DB row R as the pure keystream
ChaCha20(key, counter=0.., nonce=[s, R_lo32, R_hi32]) read as 12,800
little-endian u16 lanes (native/iris_codec.cpp ``ic_share_split``; docs/SPEC.md
section 4.1), so a keyed participant regenerates its rows from the 32-byte key
instead of storing them.

The plain half is torch ops in int64 with ``& 0xFFFFFFFF`` on both devices
(torch has no uint32 add, shift or compare on the CPU): :func:`share_rows`
(file order), :func:`share_planes_natural` (int8 lo/hi planes in natural K
order), :func:`keystream_bytes`. :func:`share_planes_kernel` launches the
CUDA kernel ``csrc/chacha_planes.cu``, the counterpart of the TPU kernel
``_words_pallas`` and its byte extraction, for a key on the card, and runs
the plain version for a key on the CPU (the reference's
``share_planes_auto`` dispatch).

Keys travel as int32 [8] tensors holding the bit patterns of the uint32 key
words (:func:`key_tensor`), so the kernel reads them from device memory and
the plain version widens them to int64.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_iris_tpu_torch.constants import BITS
from mpc_iris_tpu_torch.ops._build import check_launch, library

_CONSTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"
BLOCKS_PER_ROW = (2 * BITS) // 64  # 400 x 64-byte blocks = 25,600 B = one row
_M32 = 0xFFFFFFFF


def check_stream_id(stream_id) -> int:
    """Validate a share stream index (SPEC section 4.1): [0, 2^32-2]; 2^32-1 is
    the re-randomization stream and negatives would wrap silently (copy of
    ``mpc_iris_tpu.ops.chacha.check_stream_id``)."""
    sid = int(stream_id)
    if not 0 <= sid < 0xFFFFFFFF:
        raise ValueError(
            f"share stream id must be in [0, 2^32-2], got {stream_id}"
        )
    return sid


def key_words(key: bytes) -> np.ndarray:
    """32-byte key -> uint32[8] little-endian words (RFC 8439 section 2.3;
    copy of ``mpc_iris_tpu.ops.chacha.key_words``)."""
    key = bytes(key)
    if len(key) != 32:
        raise ValueError("ChaCha20 key must be exactly 32 bytes")
    return np.frombuffer(key, dtype="<u4").copy()


def key_tensor(key: bytes, device) -> torch.Tensor:
    """32-byte key -> int32 [8] tensor on ``device`` holding the uint32 key
    words' bit patterns (the form every function here takes)."""
    return torch.from_numpy(key_words(key).view(np.int32)).to(device)


def _u32(v, what: str) -> int:
    v = int(v)
    if not 0 <= v <= _M32:
        raise ValueError(f"{what} must be in [0, 2^32-1], got {v}")
    return v


def _rotl(x, k):
    return ((x << k) | (x >> (32 - k))) & _M32


def _quarter(s, a, b, c, d):
    sa, sb, sc, sd = s[a], s[b], s[c], s[d]
    sa = (sa + sb) & _M32
    sd = _rotl(sd ^ sa, 16)
    sc = (sc + sd) & _M32
    sb = _rotl(sb ^ sc, 12)
    sa = (sa + sb) & _M32
    sd = _rotl(sd ^ sa, 8)
    sc = (sc + sd) & _M32
    sb = _rotl(sb ^ sc, 7)
    s[a], s[b], s[c], s[d] = sa, sb, sc, sd


def _block_words(init):
    """20 ChaCha rounds over a 16-list of int64 tensors holding uint32 words;
    returns the 16 output words (working state + initial state)."""
    x = list(init)
    for _ in range(10):  # 10 double rounds: columns, then diagonals
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return [(a + b) & _M32 for a, b in zip(x, init)]


def _row_block_words(kw: torch.Tensor, stream_id, row0, n_rows: int):
    """State setup and rounds for rows [row0, row0 + n_rows) of one share
    stream: the 16 output words, int64 [n_rows, 400] each, on ``kw``'s
    device. The u64 nonce is u32 + carry, the carry taken against the global
    offset from row0 (mirrors ``_row_block_words``)."""
    dev = kw.device
    kw = kw.to(torch.int64) & _M32
    idx = torch.arange(n_rows, dtype=torch.int64, device=dev)
    lo = (_u32(row0, "row offset") + idx) & _M32
    n_lo = lo[:, None]
    n_hi = (lo < idx).to(torch.int64)[:, None]  # carry into bits 32..63
    ctr = torch.arange(BLOCKS_PER_ROW, dtype=torch.int64, device=dev)[None, :]
    shape = (n_rows, BLOCKS_PER_ROW)

    def full(v):
        return torch.as_tensor(v, dtype=torch.int64, device=dev).expand(shape)

    init = [full(c) for c in _CONSTS]
    init += [kw[i].expand(shape) for i in range(8)]
    init += [ctr.expand(shape), full(_u32(stream_id, "stream id")),
             n_lo.expand(shape), n_hi.expand(shape)]
    return _block_words(init)


def share_rows(kw: torch.Tensor, stream_id, row0, n_rows: int) -> torch.Tensor:
    """Regenerate share rows [row0, row0 + n_rows) of one share stream.

    Args:
      kw: int32 [8] key words (:func:`key_tensor`); the rows are made on its
        device.
      stream_id: the share index s (SPEC section 4.1 stream address).
      row0: first global DB row, in [0, 2^32).
      n_rows: row count.

    Returns int32 [n_rows, 12,800] holding u16 values, equal to the share file
    rows written by ``prepare`` for the same key and stream.
    """
    words = torch.stack(_row_block_words(kw, stream_id, row0, n_rows), dim=-1)  # [R, B, 16]
    # block bytes are word0..word15 LE, so the u16 lanes are (w & 0xFFFF,
    # w >> 16) pairs in word order
    lanes = torch.stack([words & 0xFFFF, words >> 16], dim=-1)  # [R, B, 16, 2]
    return lanes.reshape(n_rows, BITS).to(torch.int32)


def k_permutation() -> np.ndarray:
    """pi mapping NATURAL plane columns to file-order K indices (copy of
    ``mpc_iris_tpu.ops.chacha.k_permutation``): natural column
    j = l*6400 + w*400 + b for u16 lane l, word w, block b holds file lane
    pi[j] = b*32 + 2w + l. The share dot is invariant under one permutation of
    both operands' K axis, so the engines permute the query side once per
    batch and the keystream planes stay in the order the rounds make them."""
    j = np.arange(BITS)
    lane, rem = np.divmod(j, 16 * BLOCKS_PER_ROW)
    w, b = np.divmod(rem, BLOCKS_PER_ROW)
    return (b * 32 + 2 * w + lane).astype(np.int32)


def share_planes_natural(kw: torch.Tensor, stream_id, row0, n_rows: int):
    """Plain version of :func:`share_planes_kernel`: regenerated share rows as
    int8 (lo, hi) planes [n_rows, 12,800] in NATURAL K order
    (:func:`k_permutation`), offset -128 like ``ops.dot.shares_to_planes``."""
    words = _row_block_words(kw, stream_id, row0, n_rows)
    lo_parts, hi_parts = [], []
    for lane_shift in (0, 16):  # u16 lane l = 0, 1
        for w in words:
            v = w >> lane_shift
            lo_parts.append(((v & 0xFF) - 128).to(torch.int8))
            hi_parts.append((((v >> 8) & 0xFF) - 128).to(torch.int8))
    return torch.cat(lo_parts, dim=1), torch.cat(hi_parts, dim=1)


def share_planes_kernel(kw: torch.Tensor, stream_id, row0, n_rows: int):
    """:func:`share_planes_natural` in one launch of the CUDA kernel
    ``csrc/chacha_planes.cu``, for a key on the card (any ``n_rows >= 1``);
    a key on the CPU runs the plain version. Returns int8 (lo, hi)
    [n_rows, 12,800] on ``kw``'s device."""
    if kw.device.type == "cpu":
        return share_planes_natural(kw, stream_id, row0, n_rows)
    if kw.device.type != "cuda":
        raise ValueError(f"share_planes_kernel: unsupported device {kw.device}")
    if kw.dtype != torch.int32 or kw.shape != (8,) or not kw.is_contiguous():
        raise ValueError("share_planes_kernel: kw must be a contiguous int32 [8] "
                         "tensor of key words (key_tensor)")
    n_rows = int(n_rows)
    if not 1 <= n_rows <= 2**31 // BLOCKS_PER_ROW:
        raise ValueError(f"share_planes_kernel: unsupported n_rows={n_rows}")
    sid, r0 = _u32(stream_id, "stream id"), _u32(row0, "row offset")
    lib = library()
    lo = torch.empty((n_rows, BITS), dtype=torch.int8, device=kw.device)
    hi = torch.empty((n_rows, BITS), dtype=torch.int8, device=kw.device)
    with torch.cuda.device(kw.device):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch("share_planes_kernel", lib.chacha_planes_launch(
            kw.data_ptr(), sid, r0, n_rows, lo.data_ptr(), hi.data_ptr(), stream))
    share_planes_kernel.launches += 1
    return lo, hi


share_planes_kernel.launches = 0


def keystream_bytes(key: bytes, counter: int, nonce12: bytes, nbytes: int) -> bytes:
    """Raw keystream for test pinning (mirrors ``native.chacha20_stream``),
    computed on the CPU."""
    kw = torch.from_numpy(key_words(key).astype(np.int64))
    n = np.frombuffer(bytes(nonce12), dtype="<u4").astype(np.int64)
    blocks = -(-nbytes // 64)
    ctr = (torch.arange(blocks, dtype=torch.int64) + int(counter)) & _M32
    shape = ctr.shape
    init = [torch.full(shape, c, dtype=torch.int64) for c in _CONSTS]
    init += [kw[i].expand(shape) for i in range(8)]
    init += [ctr] + [torch.full(shape, int(x), dtype=torch.int64) for x in n]
    words = torch.stack(_block_words(init), dim=-1).numpy()  # [B, 16]
    return words.astype("<u4").tobytes()[:nbytes]


def check_share_planes(device) -> None:
    """Kernel canary: the CUDA kernel equals its plain version, bit for bit,
    at the u64 nonce carry (rows crossing 2^32 inside the launch), the
    largest valid stream id, a key with high bits set, and a ragged row
    count."""
    kw = key_tensor(bytes(range(0x80, 0xA0)), device)
    args = (kw, 0xFFFFFFFE, 0xFFFFFFF0, 37)
    got = share_planes_kernel(*args)
    want = share_planes_natural(*args)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"share_planes_kernel self-test FAILED on {device}")
