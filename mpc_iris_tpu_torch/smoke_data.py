"""Data of the card check (``chip_smoke.py``) and of its helper processes
(``parallel/party_smoke.py``, ``protocol/party_proc.py``): random packed
templates made from a seed, so a process rebuilds the same DB from the seed
alone and no data file crosses between processes."""

from __future__ import annotations

import numpy as np

from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES
from mpc_iris_tpu_torch.types import Bits

N_PLANTED = 8


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
