"""Batched int8 dots (counterpart of ``mpc_iris_tpu/ops/dot.py``, plaintext
half).

D[M, N] = Q[M, K] @ DB[N, K]^T with K = 12,800 and int32 accumulation: exact,
since |sum| <= 12,800. Hopper's tensor cores take int8 and not int4, so the
int8 product plays the role of the reference's ``dot_bits_batch_i4`` too.
``torch._int_mm`` is the product on both devices; on CUDA it requires M > 16
and K, N multiples of 8 (the engine pads its chunk to a multiple of 8).

The reference's ``kernel_self_test`` is in ops/self_test.py: it also checks
the kernel modules, which import this one.
"""

from __future__ import annotations

import torch


def dot_bits_batch(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """int8 Q [M, K] x int8 DB [N, K] -> int32 [M, N]. With {0,1} operands an
    AND-popcount; with {-1,0,1} operands the plaintext encoded dot."""
    return torch._int_mm(q, db.t())
