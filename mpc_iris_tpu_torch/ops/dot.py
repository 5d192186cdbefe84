"""Batched int8 dots (counterpart of ``mpc_iris_tpu/ops/dot.py``).

D[M, N] = Q[M, K] @ DB[N, K]^T with K = 12,800 and int32 accumulation: exact,
since |sum| <= 12,800. Hopper's tensor cores take int8 and not int4, so the
int8 product plays the role of the reference's ``dot_bits_batch_i4`` too.
``torch._int_mm`` is the product on both devices; on CUDA it requires M > 16
and K, N multiples of 8 (the engine pads its chunk to a multiple of 8).

Share dots are exact mod 2^16: a u16 share s = s_lo + 256 s_hi is held as
int8 planes offset by -128, and sum_k q*s = Q @ S_lo^T + 256 Q @ S_hi^T plus
a 128*rowsum(Q) correction per plane, reduced mod 2^16. This is the
reference's non-TPU branch (int32 and ``& 0xFFFF``); the TPU's wrapping int16
branch is not carried over. u16 values on the device are int32 in [0, 2^16).

The reference's ``kernel_self_test`` is in ops/self_test.py: it also checks
the kernel modules, which import this one.
"""

from __future__ import annotations

import numpy as np
import torch


def dot_bits_batch(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """int8 Q [M, K] x int8 DB [N, K] -> int32 [M, N]. With {0,1} operands an
    AND-popcount; with {-1,0,1} operands the plaintext encoded dot."""
    return torch._int_mm(q, db.t())


def shares_to_planes(shares_u16: torch.Tensor):
    """u16 share matrix [N, K] (uint16, int16 bit patterns or int32 values)
    -> (lo, hi) int8 planes [N, K], offset by -128:
    lo = (s & 255) - 128, hi = (s >> 8) - 128. At most two int32 [N, K]
    temporaries live at once (``s`` is a fresh tensor, updated in place)."""
    s = shares_u16.to(torch.int32) & 0xFFFF
    lo = (s & 0xFF).sub_(128).to(torch.int8)
    return lo, s.bitwise_right_shift_(8).sub_(128).to(torch.int8)


def planes_to_shares(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`shares_to_planes`: int32 [N, K] in [0, 2^16)."""
    return (lo.to(torch.int32) + 128) | ((hi.to(torch.int32) + 128) << 8)


def dot_share_batch(q_i8: torch.Tensor, db_lo: torch.Tensor, db_hi: torch.Tensor) -> torch.Tensor:
    """Exact wrapping-u16 dot of ternary queries against a u16 share DB.

    Args:
      q_i8: int8 [M, K], values in {-1, 0, 1} (rotated encoded queries).
      db_lo, db_hi: int8 [N, K] byte planes, offset -128 (:func:`shares_to_planes`).

    Returns int32 [M, N] in [0, 2^16), the reference's ``arch::dot_u16``
    pairwise. The sums update the two products in place (saves two
    [M, N] int32 temporaries); every magnitude stays below 2^30.
    """
    q_i8 = q_i8.to(torch.int8)
    total = dot_bits_batch(q_i8, db_lo)  # Q @ (S_lo - 128)^T
    d_hi = dot_bits_batch(q_i8, db_hi)  # Q @ (S_hi - 128)^T
    corr = 128 * q_i8.sum(dim=1, keepdim=True, dtype=torch.int32)  # [M, 1]
    total.add_(corr).add_(d_hi.add_(corr).mul_(256))
    return total.bitwise_and_(0xFFFF)


def dot_u16_oracle(a, b):
    """Scalar NumPy oracle for the wrapping-u16 dot (copy of
    ``mpc_iris_tpu.ops.dot.dot_u16_oracle``)."""
    prod = np.asarray(a, dtype=np.int64) * np.asarray(b, dtype=np.int64)
    return np.uint16(np.sum(prod) & 0xFFFF)
