"""Plain reference of the plaintext uniqueness DB: the exact min-distance
winner and the threshold audit, from the packed inputs alone.

Semantics (upstream src/template.rs, src/lib.rs:97-107): per (query, entry)
and rotation r in -15..15 of the query's columns, with m the AND of the two
masks, n = popcount((p_q ^ p_e) & m) and d = popcount(m); the entry's
fraction is the least n/d over r (d = 0 never counts), the earliest rotation
on equal fractions; the winner is the entry of the least fraction, the lowest
index on equal fractions; its distance is the f64 n / d.

Computed here in float32 products with TF32 off: the encodings (+1, -1, 0)
and masks (1, 0) give exact integer sums below 2^24. The order of fractions
is taken from an integer key floor(n 2^40 / d): two unequal fractions of
denominators up to 12,800 differ by at least 1 / 12,800^2, more than 6,000
steps of the key, and equal fractions have equal keys, so the key orders them
exactly. The winner is the lexicographic minimum of (key, index), kept as two
numbers, so the DB may hold any number of entries. Imports nothing of the
port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.data import BITS, COLS, ROTATIONS, ROWS

KEY_SHIFT = 40
INVALID = (1 << KEY_SHIFT) + 1  # above every valid key (n <= d)


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., k] -> {0, 1} uint8 [..., 8k], bit i of byte j at 8j + i."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed.unsqueeze(-1) >> shifts) & 1).reshape(*packed.shape[:-1], -1)


def query_rows(pat: np.ndarray, msk: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed queries uint8 [Q, 1600] -> float32 [Q * 31, 12800] encodings
    m (1 - 2 p) and masks m of the rotated queries, rotation -15..15 in order
    within a query."""
    q = pat.shape[0]
    p = unpack(torch.from_numpy(np.ascontiguousarray(pat)).to(device)).reshape(q, ROWS, COLS)
    m = unpack(torch.from_numpy(np.ascontiguousarray(msk)).to(device)).reshape(q, ROWS, COLS)
    p = torch.stack([torch.roll(p, r, dims=2) for r in ROTATIONS], dim=1).float()
    m = torch.stack([torch.roll(m, r, dims=2) for r in ROTATIONS], dim=1).float()
    return (m * (1 - 2 * p)).reshape(-1, BITS), m.reshape(-1, BITS)


def entry_fractions(q_enc, q_mask, pat_blk: torch.Tensor, msk_blk: torch.Tensor):
    """One block of entries against Q queries: per (query, entry) the
    rotation minimum as int64 [Q, n] (key, n, d)."""
    m = unpack(msk_blk).float()
    e = m * (1 - 2 * unpack(pat_blk).float())
    dot = q_enc @ e.T
    den = q_mask @ m.T
    del m, e
    d = den.round().to(torch.int64)
    n = ((den - dot).round().to(torch.int64)) >> 1
    key = torch.where(d > 0, (n << KEY_SHIFT) // d.clamp(min=1), INVALID)
    q = q_enc.shape[0] // len(ROTATIONS)
    rot = torch.arange(len(ROTATIONS), device=key.device)[None, :, None]
    best = (key.reshape(q, len(ROTATIONS), -1) * 32 + rot).min(dim=1).values
    r = (best % 32).unsqueeze(1)
    n = n.reshape(q, len(ROTATIONS), -1).gather(1, r).squeeze(1)
    d = d.reshape(q, len(ROTATIONS), -1).gather(1, r).squeeze(1)
    return best // 32, n, d


def _blocks(db_pat: np.ndarray, db_msk: np.ndarray, device, block: int):
    for start in range(0, db_pat.shape[0], block):
        end = min(db_pat.shape[0], start + block)
        yield start, (torch.from_numpy(db_pat[start:end]).to(device),
                      torch.from_numpy(db_msk[start:end]).to(device))


def _f64(n: int, d: int, dtype) -> float:
    return float(dtype(n) / dtype(d)) if d else float("inf")


@dataclass
class Winners:
    """The running winner of each query: fraction key, DB index, n, d,
    int64 [Q] each. A query that no entry has an unmasked bit in keeps
    index 0, n = d = 0."""

    key: torch.Tensor
    index: torch.Tensor
    n: torch.Tensor
    d: torch.Tensor

    @classmethod
    def none(cls, q: int, device) -> Winners:
        key = torch.full((q,), INVALID, dtype=torch.int64, device=device)
        zero = torch.zeros_like(key)
        return cls(key, zero, zero, zero)

    def fold(self, key, n, d, start: int) -> Winners:
        """Fold in one block of entries, ``start`` its first DB index, as
        int64 [Q, b] (key, n, d): within the block the least key, then the
        least index at that key; against the running winner the block wins
        only on a strictly lower key, so ties keep the earlier block's."""
        v = key.min(dim=1).values
        col = torch.arange(key.shape[1], device=key.device)
        j = torch.where(key == v[:, None], col, key.shape[1]).min(dim=1).values[:, None]
        win = v < self.key
        return Winners(torch.where(win, v, self.key),
                       torch.where(win, start + j.squeeze(1), self.index),
                       torch.where(win, n.gather(1, j).squeeze(1), self.n),
                       torch.where(win, d.gather(1, j).squeeze(1), self.d))


def match(db_pat, db_msk, pat, msk, device, block: int = 16384, dtype=np.float64):
    """Per query the winner (index, n, d, distance): packed DB uint8
    [N, 1600] x2 on the host, packed queries [Q, 1600]. ``dtype``: the
    precision of the distance (float64 as stated; the control takes the
    next one down)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q_enc, q_mask = query_rows(pat, msk, device)
    best = Winners.none(pat.shape[0], device)
    for start, (p, m) in _blocks(db_pat, db_msk, device, block):
        best = best.fold(*entry_fractions(q_enc, q_mask, p, m), start)
    return [(i, n, d, _f64(n, d, dtype))
            for i, n, d in zip(best.index.tolist(), best.n.tolist(), best.d.tolist())]


def audit(db_pat, db_msk, pat, msk, threshold: float, device, block: int = 16384,
          dtype=np.float64):
    """Per query every entry whose fraction is strictly under ``threshold``
    by the exact rational compare, as (index, n, d, distance), ascending by
    fraction, index-ordered within equal fractions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tn, td = float(threshold).as_integer_ratio()
    q_enc, q_mask = query_rows(pat, msk, device)
    hits = [[] for _ in range(pat.shape[0])]
    for start, (p, m) in _blocks(db_pat, db_msk, device, block):
        key, n, d = entry_fractions(q_enc, q_mask, p, m)
        # a superset on the device, the exact compare in Python integers
        near = (d > 0) & (n.double() < d.double() * (threshold + 1e-9))
        q, e = near.nonzero(as_tuple=True)
        for q, e, k, nn, dd in torch.stack([q, e, key[q, e], n[q, e], d[q, e]], 1).tolist():
            if nn * td < tn * dd:
                hits[q].append((k, start + e, nn, dd))
    return [[(i, n, d, _f64(n, d, dtype)) for _, i, n, d in sorted(h)] for h in hits]
