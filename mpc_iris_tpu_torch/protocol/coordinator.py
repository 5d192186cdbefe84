"""The coordinator's device steps (counterpart of the decode steps in
``mpc_iris_tpu/protocol/coordinator.py``): per received round, the wrapping
sum of the P parties' dot shares, the distance decode against the
denominators, the rotation min and, for the match, the entry argmin.

Share reconstruction is a sum mod 2^16 (reference src/main.rs:597-612) and
the numerator ``((den - dot) mod 2^16) >> 1`` (the wrapping sub of reference
src/lib.rs:104). Selection is the exact rational order with d == 0 as +inf,
ties to the earliest rotation and then the lowest index (ops/decode.py).
Inputs are integer tensors holding u16 values: the engines' int16 blocks of
u16 bit patterns, or int32 values; all arithmetic is int32 with
``& 0xFFFF`` (torch has no uint16 arithmetic on the CPU).

The asyncio roles (``Coordinator``, ``ParticipantServer``) follow with the
CLI; until then the JAX package's roles serve the port's engines.
"""

from __future__ import annotations

import torch

from mpc_iris_tpu_torch.ops.decode import fraction_argmin, fraction_min_rotations


def _decode(shares, dens):
    """(num, den) int32 from P share blocks and the denominators."""
    dots = shares[0].to(torch.int32)
    for s in shares[1:]:
        dots = dots + s.to(torch.int32)
    den = dens.to(torch.int32) & 0xFFFF
    return ((den - dots) & 0xFFFF) >> 1, den


def _sum_decode_argmin_device_batch(shares, dens) -> torch.Tensor:
    """Batched round: tuple of P [n, B, 31] ENTRY-major dot-share blocks and
    the denominators -> int32 [3, B] winners (numerator, denominator,
    round-local index)."""
    num, den = _decode(shares, dens)
    n_r, d_r, _ = fraction_min_rotations(num, den, axis=2)  # [n, B]
    return torch.stack(fraction_argmin(n_r, d_r, axis=0))  # over entries -> [B]


def _sum_decode_argmin_device(shares, dens) -> torch.Tensor:
    """One query's round: tuple of P [n, 31] dot-share blocks and the
    denominators -> int32 [3] winner (numerator, denominator, round-local
    index)."""
    num, den = _decode(shares, dens)
    n_r, d_r, _ = fraction_min_rotations(num, den, axis=1)
    return torch.stack(fraction_argmin(n_r, d_r, axis=0))


def _sum_decode_minfrac_device_batch(shares, dens) -> torch.Tensor:
    """Batched threshold-audit round: tuple of P [n, B, 31] ENTRY-major
    blocks and the denominators -> int32 [2, n, B], per entry the minimal
    (numerator, denominator)."""
    num, den = _decode(shares, dens)
    n_r, d_r, _ = fraction_min_rotations(num, den, axis=2)
    return torch.stack([n_r, d_r])


def _sum_decode_minfrac_device(shares, dens) -> torch.Tensor:
    """One query's audit round: tuple of P [n, 31] blocks and the
    denominators -> int32 [2, n] per-entry minimal (numerator, denominator);
    the entry axis is kept so the host can list every entry under a
    threshold."""
    num, den = _decode(shares, dens)
    n_r, d_r, _ = fraction_min_rotations(num, den, axis=1)
    return torch.stack([n_r, d_r])


def _frac_less_host(n1: int, d1: int, n2: int, d2: int) -> bool:
    """Exact n1/d1 < n2/d2 on Python ints, d == 0 as +inf (copy of
    ``mpc_iris_tpu.protocol.coordinator._frac_less_host``)."""
    if d1 == 0:
        return False
    if d2 == 0:
        return True
    return n1 * d2 < n2 * d1
