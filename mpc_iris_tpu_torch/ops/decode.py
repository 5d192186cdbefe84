"""Exact fraction selection on tensors, and the host f64 decode
(counterpart of ``mpc_iris_tpu/ops/decode.py``).

Distances are fractions n/d of int32 values <= 12,800; the exact rational
order n1/d1 < n2/d2 is the int32 compare n1*d2 < n2*d1. d == 0 is +inf. Ties
in the exact order go to the lower index (earlier rotation, lower DB index),
which makes every selection here a lexicographic minimum over
(fraction, index): its result does not depend on the reduction order.

These functions are also the plain versions the CUDA selection kernels are
held against (ops/select.py, ops/packed_match.py). The host half at the end
(f64 decode, the exact threshold compare of the audit) is numpy.
"""

from __future__ import annotations

import numpy as np
import torch

# Index of padding candidates: loses every tie against a real index.
INDEX_PAD = 2**31 - 1


def numerators(dots: torch.Tensor, dens: torch.Tensor) -> torch.Tensor:
    """``n = ((d - dot) mod 2^16) >> 1`` in int32 (mirrors
    ``decode.numerators``)."""
    d = dens.to(torch.int32)
    t = dots.to(torch.int32)
    return ((d - t) & 0xFFFF) >> 1


def _frac_less(n1, d1, n2, d2):
    """Exact (n1/d1) < (n2/d2) with d == 0 treated as +inf."""
    v1 = d1 > 0
    v2 = d2 > 0
    return (v1 & ~v2) | (v1 & v2 & (n1 * d2 < n2 * d1))


def _frac_select(n1, d1, i1, n2, d2, i2):
    """Select the smaller fraction; ties (and both-invalid) keep the smaller
    index (mirrors ``decode._frac_select``)."""
    p1 = n1 * d2
    p2 = n2 * d1
    v1 = d1 > 0
    v2 = d2 > 0
    less = (v1 & ~v2) | (v1 & v2 & (p1 < p2))
    greater = (v2 & ~v1) | (v1 & v2 & (p2 < p1))
    pick1 = less | (~greater & (i1 <= i2))
    return (
        torch.where(pick1, n1, n2),
        torch.where(pick1, d1, d2),
        torch.where(pick1, i1, i2),
    )


def fraction_min_rotations(nums, dens, axis=-1):
    """Reduce the rotation axis: per entry the minimal (n, d) and its slot r.

    int32 [..., R] (or ``axis`` elsewhere) -> (n, d, r) without that axis;
    ties keep the earliest slot. A running fold of index-aware selects, which
    gives the same pair as the reference's tree (see module docstring).
    """
    nums = nums.to(torch.int32).movedim(axis, -1)
    dens = dens.to(torch.int32).movedim(axis, -1)
    n, d = nums[..., 0], dens[..., 0]
    r = torch.zeros_like(n)
    for k in range(1, nums.shape[-1]):
        n, d, r = _frac_select(n, d, r, nums[..., k], dens[..., k],
                               torch.full_like(r, k))
    return n, d, r


def fraction_argmin(nums, dens, axis=-1, index_offset: int = 0):
    """Argmin of exact fractions along ``axis`` by a halving tree of selects.

    Returns (n, d, idx) int32 with ``axis`` reduced; ``index_offset`` is added
    to the indices; ties keep the smallest index (mirrors
    ``decode.fraction_argmin``)."""
    nums = nums.to(torch.int32).movedim(axis, -1)
    dens = dens.to(torch.int32).movedim(axis, -1)
    size = nums.shape[-1]
    idx = torch.arange(size, dtype=torch.int32, device=nums.device) + index_offset
    idx = idx.expand(nums.shape)
    pow2 = 1 << (size - 1).bit_length()
    if pow2 != size:
        # invalid (d = 0) padding loses every compare
        shape = (*nums.shape[:-1], pow2 - size)
        zeros = nums.new_zeros(shape)
        nums = torch.cat([nums, zeros], dim=-1)
        dens = torch.cat([dens, zeros], dim=-1)
        idx = torch.cat([idx, torch.full_like(zeros, INDEX_PAD)], dim=-1)
    while pow2 > 1:
        half = pow2 // 2
        nums, dens, idx = _frac_select(
            nums[..., :half], dens[..., :half], idx[..., :half],
            nums[..., half:], dens[..., half:], idx[..., half:],
        )
        pow2 = half
    return nums[..., 0], dens[..., 0], idx[..., 0]


def running_min(state, n, d, i):
    """Fold a new (n, d, idx) candidate batch into the carried best state."""
    return _frac_select(*state, n, d, i)


def initial_state(b: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The running-min start: (0, 0, INDEX_PAD), an invalid candidate that
    every real one replaces."""
    zeros = torch.zeros(b, dtype=torch.int32, device=device)
    return zeros, zeros.clone(), torch.full_like(zeros, INDEX_PAD)


def chunk_winners(dot, den, rows_per_query: int, index_offset: int = 0):
    """Plain chunk selection over matmul outputs.

    dot, den: [B*R, N] with R = ``rows_per_query`` rotation rows per query in
    natural rotation order. num = (den - dot) >> 1 (den - dot = 2 * #unequal),
    then the rotation min and the column argmin. Returns (n, d, idx) int32 [B].
    """
    n_cols = dot.shape[-1]
    dot = dot.to(torch.int32).reshape(-1, rows_per_query, n_cols)
    den = den.to(torch.int32).reshape(-1, rows_per_query, n_cols)
    n_r, d_r, _ = fraction_min_rotations((den - dot) >> 1, den, axis=1)
    return fraction_argmin(n_r, d_r, axis=-1, index_offset=index_offset)


# ----------------------------------------------------------------- host decode (f64)


def decode_distance(dots, dens) -> float:
    """Reference-exact f64 decode of one entry's 31 (dot, den) pairs
    (src/lib.rs:97-107; copy of ``mpc_iris_tpu.ops.decode.decode_distance``):
    the minimum of ``((den - dot) mod 2^16 >> 1) / den`` over the rotations,
    NaN (0/0) skipped as Rust's ``f64::min`` skips it; +inf when every den
    is 0."""
    dots = np.asarray(dots, dtype=np.uint16).astype(np.int64)
    dens = np.asarray(dens, dtype=np.uint16).astype(np.int64)
    n = ((dens - dots) & 0xFFFF) >> 1
    best = float("inf")
    for nr, dr in zip(n.tolist(), dens.tolist()):
        with np.errstate(invalid="ignore", divide="ignore"):
            v = float(np.float64(nr) / np.float64(dr))
        if v < best:  # NaN compares false, so it is skipped
            best = v
    return best


def decode_distance_batch_np(dots, dens) -> np.ndarray:
    """Host decode: [N, 31] u16 dots & dens -> [N] f64 distances.

    Copy of ``mpc_iris_tpu.ops.decode.decode_distance_batch_np`` (that module
    imports jax): correctly-rounded f64 division and a NaN-skipping min.
    """
    dots = np.asarray(dots, dtype=np.uint16).astype(np.int64)
    dens = np.asarray(dens, dtype=np.uint16).astype(np.int64)
    n = ((dens - dots) & 0xFFFF) >> 1
    with np.errstate(invalid="ignore", divide="ignore"):
        vals = n.astype(np.float64) / dens.astype(np.float64)
    vals = np.where(np.isnan(vals), np.inf, vals)
    return vals.min(axis=-1)


def fraction_to_f64(n: int, d: int) -> float:
    """Host f64 of a winning integer pair; d == 0 is +inf.

    Copy of ``mpc_iris_tpu.ops.decode.fraction_to_f64``."""
    if d == 0:
        return float("inf")
    return float(np.float64(int(n)) / np.float64(int(d)))


def fractions_to_f64_np(nums, dens) -> np.ndarray:
    """Host f64 of (numerator, denominator) pairs, correctly rounded per
    element; d == 0 is +inf.

    Copy of ``mpc_iris_tpu.ops.decode.fractions_to_f64_np``."""
    n = np.asarray(nums, dtype=np.int64)
    d = np.asarray(dens, dtype=np.int64)
    with np.errstate(invalid="ignore", divide="ignore"):
        vals = n.astype(np.float64) / d.astype(np.float64)
    return np.where(d == 0, np.inf, vals)


def under_threshold_mask_np(nums, dens, threshold: float) -> np.ndarray:
    """Exact boolean mask of ``n/d < threshold`` per element; d == 0 never
    matches.

    Copy of ``mpc_iris_tpu.ops.decode.under_threshold_mask_np``: the finite
    f64 ``threshold`` is the exact binary rational it represents. The
    correctly-rounded f64 quotient decides every element whose quotient
    differs from the threshold; an element whose quotient equals it is
    settled by exact integer cross-products (int64 where both fit, Python
    integers over object arrays where they would overflow), so a distance
    exactly on the threshold is excluded (strict ``<``).
    """
    n = np.asarray(nums, dtype=np.int64)
    d = np.asarray(dens, dtype=np.int64)
    t = float(threshold)
    valid = d > 0
    if np.isnan(t) or t <= 0.0:
        return np.zeros(n.shape, dtype=bool)
    if np.isinf(t):
        return valid
    with np.errstate(invalid="ignore", divide="ignore"):
        vals = n.astype(np.float64) / d.astype(np.float64)
    definite = valid & (vals < t)
    ambiguous = valid & (vals == t)
    if ambiguous.any():
        tn, td = t.as_integer_ratio()
        na = n[ambiguous]
        da = d[ambiguous]
        nmax = int(abs(na).max(initial=0))
        dmax = int(da.max(initial=0))
        if tn * dmax < 2**63 and td * max(nmax, 1) < 2**63:
            res = na * np.int64(td) < np.int64(tn) * da
        else:
            res = (na.astype(object) * td < tn * da.astype(object)).astype(bool)
        definite[ambiguous] = res
    return definite
