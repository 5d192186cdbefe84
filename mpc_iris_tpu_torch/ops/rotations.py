"""Rotation expansion of a query over its 31 column rotations
(counterpart of ``mpc_iris_tpu/ops/rotations.py``).

Rotating by ``amount`` places old column ``(j - amount) mod 200`` at new
column ``j``: ``torch.roll(grid, amount, dims=-1)`` on the [..., 64, 200] grid.
"""

from __future__ import annotations

import torch

from mpc_iris_tpu_torch.constants import COLS, N_ROTATIONS, ROTATIONS, ROWS


def rotate_grid(grid: torch.Tensor, amount: int) -> torch.Tensor:
    """Rotate a [..., ROWS, COLS] grid by ``amount`` columns."""
    if amount % COLS == 0:
        return grid
    return torch.roll(grid, shifts=amount, dims=-1)


def expand_rotations(grid: torch.Tensor) -> torch.Tensor:
    """[..., ROWS, COLS] -> [N_ROTATIONS, ..., ROWS, COLS], rotation -15..+15
    in order."""
    return torch.stack([rotate_grid(grid, r) for r in ROTATIONS], dim=0)


def expand_rotations_flat(grid: torch.Tensor) -> torch.Tensor:
    """[B, ROWS, COLS] -> [B, N_ROTATIONS, ROWS*COLS]: matmul-LHS rows grouped
    per query."""
    rots = expand_rotations(grid).movedim(0, 1)
    return rots.reshape(rots.shape[0], N_ROTATIONS, ROWS * COLS)
