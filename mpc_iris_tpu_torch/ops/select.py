"""Fused exact selection over one DB chunk's matmul outputs
(counterpart of ``mpc_iris_tpu/ops/select_pallas.py``).

:func:`select_chunk` launches the CUDA kernel ``csrc/select_chunk.cu`` for a
CUDA tensor and takes :func:`select_chunk_reference`, its plain version, for a
CPU tensor. The public layout is the reference's: rows padded to 32 rotation
rows per query and fed in bit-reversed rotation order (``ROT_BITREV``), row
32b+31 a dummy with den == 0. The reference's tile rules (tile_b, tile_n =
128 * 2^k) existed for the TPU compiler and are gone: any B >= 1 and N >= 1.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_iris_tpu_torch.ops._build import check_launch, library
from mpc_iris_tpu_torch.ops.decode import _frac_select, chunk_winners

# Rotation rows per query in the fused layout (31 rotations + 1 dummy).
N_ROT_PAD = 32


def _bitrev5(x):
    x = np.asarray(x)
    out = np.zeros_like(x)
    for i in range(5):
        out |= ((x >> i) & 1) << (4 - i)
    return out


# Position p of a query's 32 rows holds rotation bitrev5(p) (an involution;
# bitrev5(31) == 31 keeps the dummy row last). The reference needs this order
# for its keep-first tree; the kernels here compare rotation indices instead,
# and keep the order only so both packages take identical arrays.
ROT_BITREV = _bitrev5(np.arange(N_ROT_PAD))


def select_chunk_reference(dot: torch.Tensor, den: torch.Tensor,
                           index_offset: int = 0):
    """Plain version of :func:`select_chunk`: undo the bit-reversed rotation
    order, then the rotation min and the column argmin of ops/decode.py."""
    n_cols = dot.shape[1]
    rev = torch.as_tensor(ROT_BITREV, device=dot.device)
    dot = dot.reshape(-1, N_ROT_PAD, n_cols)[:, rev].reshape(-1, n_cols)
    den = den.reshape(-1, N_ROT_PAD, n_cols)[:, rev].reshape(-1, n_cols)
    return chunk_winners(dot, den, N_ROT_PAD, index_offset)


def select_chunk(dot: torch.Tensor, den: torch.Tensor, index_offset: int = 0):
    """Exact selection over one chunk's matmul outputs.

    Args:
      dot, den: int32 [B*32, N] numerator-dot and denominator matmul outputs,
        rows in the ``ROT_BITREV`` order, row 32b+31 with den == 0 (int16 is
        also accepted on the CPU).
      index_offset: added to the column index (the chunk's first DB index).

    Returns (n, d, idx) int32 [B]: per query the exact rational argmin, ties
    to the earliest rotation and then the lowest DB index. An all-invalid
    chunk gives d == 0 at its lowest index.
    """
    if dot.dim() != 2 or dot.shape != den.shape or dot.shape[0] % N_ROT_PAD:
        raise ValueError(f"select_chunk: dot/den must be equal [B*32, N], got "
                         f"{tuple(dot.shape)} and {tuple(den.shape)}")
    if dot.device != den.device:
        raise ValueError("select_chunk: dot and den on different devices")
    if dot.device.type == "cpu":
        return select_chunk_reference(dot, den, index_offset)
    if dot.device.type != "cuda":
        raise ValueError(f"select_chunk: unsupported device {dot.device}")
    if dot.dtype != torch.int32 or den.dtype != torch.int32:
        raise TypeError("select_chunk: the CUDA kernel takes int32 dot/den")
    if not (dot.is_contiguous() and den.is_contiguous()):
        raise ValueError("select_chunk: dot/den must be contiguous")
    b = dot.shape[0] // N_ROT_PAD
    n_cols = dot.shape[1]
    if not (1 <= b <= 65535 and 1 <= n_cols and index_offset + n_cols < 2**31):
        raise ValueError(f"select_chunk: unsupported shape B={b} N={n_cols}")
    lib = library()
    part = torch.empty(3 * b * lib.select_chunk_parts(n_cols),
                       dtype=torch.int32, device=dot.device)
    out = torch.empty((3, b), dtype=torch.int32, device=dot.device)
    with torch.cuda.device(dot.device):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch("select_chunk", lib.select_chunk_launch(
            dot.data_ptr(), den.data_ptr(), b, n_cols, int(index_offset),
            part.data_ptr(), out.data_ptr(), stream))
    select_chunk.launches += 1
    return out[0], out[1], out[2]


select_chunk.launches = 0


def fold_candidates(n, d, idx, axis=-1):
    """Fold per-tile winner triples along ``axis`` (ties keep the lower idx;
    mirrors ``select_pallas.fold_candidates``)."""
    n = n.movedim(axis, -1)
    d = d.movedim(axis, -1)
    idx = idx.movedim(axis, -1)
    while n.shape[-1] > 1:
        half = (n.shape[-1] + 1) // 2
        if n.shape[-1] % 2:  # odd: the last candidate meets itself
            n, d, idx = (torch.cat([t, t[..., -1:]], dim=-1) for t in (n, d, idx))
        n, d, idx = _frac_select(n[..., :half], d[..., :half], idx[..., :half],
                                 n[..., half:], d[..., half:], idx[..., half:])
    return n[..., 0], d[..., 0], idx[..., 0]


def planted_select_case(rng: np.random.Generator, n_cols: int = 1000):
    """dot/den int32 [3*32, n_cols] in the fused layout, with planted traps.

    - query 0: at column 5, rotations 3 and 9 both reach distance 0, as the
      different pairs 0/2 and 0/4; rotation 9's row (18) comes before
      rotation 3's (24) in the bit-reversed feed. Winner: (0, 2, 5).
    - query 1: columns 129 and 257 (congruent mod 128) are exact duplicates
      at distance 0. Winner: column 129.
    - query 2: every den is 0 (all invalid). Winner: column 0, with d == 0.
    Every other distance is positive; row 31 of every query has den == 0.
    """
    den = rng.integers(1, 12801, size=(3, N_ROT_PAD, n_cols))
    num = np.minimum(rng.integers(1, 12801, size=den.shape), den)
    pos = ROT_BITREV  # natural rotation r sits at row ROT_BITREV[r]
    num[0, :, 5] = den[0, :, 5]
    num[0, pos[3], 5], den[0, pos[3], 5] = 0, 2
    num[0, pos[9], 5], den[0, pos[9], 5] = 0, 4
    num[1, :, 257], den[1, :, 257] = num[1, :, 129], den[1, :, 129]
    num[1, pos[0], [129, 257]] = 0
    den[2] = 0
    den[:, N_ROT_PAD - 1] = 0
    dot = den - 2 * num
    return (dot.reshape(-1, n_cols).astype(np.int32),
            den.reshape(-1, n_cols).astype(np.int32))


def check_select_chunk(device) -> None:
    """Kernel canary: the CUDA kernel equals its plain version, bit for bit,
    on planted ties and a ragged column count. Raises on any mismatch."""
    rng = np.random.default_rng(0x5E1)
    dot, den = planted_select_case(rng)
    dot_t = torch.from_numpy(dot).to(device)
    den_t = torch.from_numpy(den).to(device)
    got = torch.stack(select_chunk(dot_t, den_t, 77)).cpu()
    want = torch.stack(select_chunk_reference(dot_t, den_t, 77)).cpu()
    if not torch.equal(got, want):
        raise RuntimeError(f"select_chunk kernel self-test FAILED on {device}: "
                           f"{got.tolist()} != {want.tolist()}")
