"""Data of the card check (``chip_smoke.py``) and of its helper processes
(``parallel/party_smoke.py``, ``protocol/party_proc.py``): random packed
templates made from a seed, so a process rebuilds the same DB from the seed
alone and no data file crosses between processes. Also the select probes'
inputs (:func:`probe_inputs`, :func:`tie_case`) and the stream probes'
(:func:`stream_inputs`), which the probe runners, ``chip_smoke.py`` and the
tests share."""

from __future__ import annotations

import numpy as np
import torch

from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES
from mpc_iris_tpu_torch.types import Bits

N_PLANTED = 8
_ROWS = 32  # a select probe query's rows: 31 rotations and a dummy
# the stream probes' ranges [lo, hi) of dot and den: dma_probe.py and
# morph_probe.py's, then select_bisect.py's
STREAM_RANGES = ((-100, 100), (0, 100))
BISECT_RANGES = ((-12_800, 12_801), (0, 12_801))


def make_db(rng: np.random.Generator, n: int):
    """Random packed DB uint8 [n, 1600] x2 with 8 planted entries, whose
    rotated copies are the first 8 of 128 queries, and planted[0] duplicated
    at a higher index in another chunk, congruent to it mod 128. Returns
    (patterns, masks, planted, duplicate, query patterns, query masks)."""
    pat = np.frombuffer(rng.bytes(n * BITS_BYTES), np.uint8).reshape(n, BITS_BYTES).copy()
    msk = np.frombuffer(rng.bytes(n * BITS_BYTES), np.uint8).reshape(n, BITS_BYTES).copy()
    planted = np.sort(rng.choice(n // 2, N_PLANTED, replace=False))
    dup = int(planted[0]) + 128 * (n // 256)
    pat[dup], msk[dup] = pat[planted[0]], msk[planted[0]]
    rots = rng.integers(-15, 16, N_PLANTED)
    qpat = np.stack([Bits(pat[i]).rotated(int(r)).data for i, r in zip(planted, rots)])
    qmsk = np.stack([Bits(msk[i]).rotated(int(r)).data for i, r in zip(planted, rots)])
    extra = 128 - N_PLANTED
    qpat = np.concatenate([qpat, rng.integers(0, 256, (extra, BITS_BYTES), dtype=np.uint8)])
    qmsk = np.concatenate([qmsk, rng.integers(0, 256, (extra, BITS_BYTES), dtype=np.uint8)])
    return pat, msk, planted, dup, qpat, qmsk


def db_rng(seed: int) -> np.random.Generator:
    """The generator of a served DB: the serving processes and the caller
    both draw it from here."""
    return np.random.default_rng([seed, 1])


def make_data(seed: int, n: int, n_share: int):
    """A party's data from ``seed``: packed patterns and masks uint8
    [n, 1600] and one share uint16 [n_share, 12800] (writable copies)."""
    rng = np.random.default_rng(seed)
    pat = np.frombuffer(rng.bytes(n * BITS_BYTES), np.uint8).reshape(n, BITS_BYTES).copy()
    msk = np.frombuffer(rng.bytes(n * BITS_BYTES), np.uint8).reshape(n, BITS_BYTES).copy()
    share = np.frombuffer(rng.bytes(n_share * BITS * 2), np.uint16).reshape(n_share, BITS).copy()
    return pat, msk, share


def query_rows(n: int, b: int) -> np.ndarray:
    """The DB rows whose copies are the queries: spread over the DB, so
    every shard holds some."""
    return np.linspace(0, n - 1, b).astype(np.int64)


def probe_inputs(b: int, n: int, seed: int, device, dtype=torch.int32):
    """The select probes' inputs, made on ``device`` from ``seed``: den and num
    uniform in [0, 12,800], num <= den, dot = den - 2 num (so that (den - dot)
    >> 1 gives num back), as ``dtype`` [b*32, n]."""
    g = torch.Generator(device=device).manual_seed(seed)
    den = torch.randint(0, 12_801, (b * _ROWS, n), generator=g, device=device,
                        dtype=torch.int32)
    num = torch.randint(0, 12_801, (b * _ROWS, n), generator=g, device=device,
                        dtype=torch.int32)
    num = torch.minimum(num, den)
    return (den - 2 * num).to(dtype), den.to(dtype)


def stream_inputs(rows: int, n: int, seed: int, device, ranges=STREAM_RANGES):
    """The stream probes' int32 dot, den [rows, n], uniform in ``ranges``
    (dot's, den's), made on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randint(lo, hi, (rows, n), generator=g, device=device, dtype=torch.int32)
                 for lo, hi in ranges)


def tie_case(b: int = 8, n: int = 4096, seed: int = 3, dtype=np.int32):
    """numpy dot, den [b*32, n] of ``dtype`` full of exact ties (b >= 8, n a
    multiple of 2,048).

    - Query 0, the f32 disagreement: every place 12,800/12,800 but
      12,799/12,800 at column 0 and 12,798/12,799 at column 1,024, which meet
      at the first level of the column tree: ``i32`` returns (12,798, 12,799,
      1,024), ``f32`` (12,799, 12,800, 0).
    - Query 1, congruent duplicates: every place 12,800/12,800 but 0/4 at
      column 129 and 0/2 at column 257: a tile of 2,048 keeps 257 (its tree
      pairs them at the 128 level, 257 first), a tile of 128 keeps 129 (the
      fold in tile order).
    - The other queries: denominators 1 .. 4 and a quarter of the numerators
      0, so that many columns and rows reach 0 as different pairs.
    """
    rng = np.random.default_rng(seed)
    den = rng.integers(1, 5, (b * _ROWS, n))
    num = np.where(rng.random(den.shape) < 0.25, 0, rng.integers(0, 5, den.shape))
    num = np.minimum(num, den)
    den[:2 * _ROWS] = num[:2 * _ROWS] = 12_800
    num[0, 0], den[0, 0] = 12_799, 12_800
    num[0, 1024], den[0, 1024] = 12_798, 12_799
    num[_ROWS, [129, 257]], den[_ROWS, [129, 257]] = 0, (4, 2)
    return (den - 2 * num).astype(dtype), den.astype(dtype)
