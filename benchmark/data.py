"""Inputs made from ``--seed``: the enrolled DB, the request pool, the keys.

Frozen copy of ``mpc_iris_tpu_torch/smoke_data.py::make_db``'s idea (a random
packed DB with rotated copies of enrolled entries among the queries),
rewritten to make the DB on the card in two calls of a ``torch.Generator``
there, and to give every seed the same sizes and the same number of copies,
so that the seed changes the data and not the work. Imports nothing of the
port.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

# The iris code (src/lib.rs:10-12 of the upstream project): a 64 x 200 grid of
# masked bits, 1,600 bytes a packed plane, rotations -15..15 of its columns.
ROWS, COLS = 64, 200
BITS = ROWS * COLS
BITS_BYTES = BITS // 8
ROTATIONS = tuple(range(-15, 16))


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose, from any whole ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def device_planes(n: int, seed: int, purpose: str, device) -> torch.Tensor:
    """uint8 [n, 1600] random bytes, made on ``device`` in one call."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, purpose))
    return torch.randint(0, 256, (n, BITS_BYTES), generator=g, dtype=torch.uint8,
                         device=device)


@dataclass
class Clusters:
    """Near-copies of enrolled entries planted in the DB: cluster c copies
    entry ``sources[c]`` into ``sizes[c]`` other entries."""

    sources: np.ndarray  # int64 [C]
    sizes: np.ndarray  # int64 [C]
    at: np.ndarray  # int64 [sizes.sum()]: the copies' places, cluster by cluster


def plan_clusters(traffic: dict, n: int, seed: int) -> Clusters:
    """The clusters of a traffic mix's ``db_clusters``, a list of [count,
    size]: ``count`` clusters of ``size`` near-copies each, sources and
    copies at distinct places drawn from the seed; none without the key."""
    sizes = np.array([int(size) for count, size in traffic.get("db_clusters", ())
                      for _ in range(int(count))], dtype=np.int64)
    rng = np.random.default_rng(sub_seed(seed, "clusters"))
    at = rng.choice(n, len(sizes) + int(sizes.sum()), replace=False).astype(np.int64)
    return Clusters(at[:len(sizes)], sizes, at[len(sizes):])


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [k, 1600] -> {0, 1} uint8 [k, 12800], bit i of byte j at 8j + i."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed.unsqueeze(-1) >> shifts) & 1).reshape(packed.shape[0], -1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`unpack_bits`."""
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return (bits.reshape(bits.shape[0], -1, 8).to(torch.int32) << shifts).sum(-1).to(torch.uint8)


def plant_clusters(plane: torch.Tensor, clusters: Clusters, flip_bits: int, seed: int,
                   block: int = 4096) -> None:
    """Write each cluster's copies into one DB plane on its device, in place:
    the source rotated by -15..15 columns (the same rotations for both
    planes), and in the pattern plane ``flip_bits`` bits drawn for flipping
    (a bit drawn twice flips once)."""
    device = plane.device
    g_rot, g_flip = torch.Generator(device=device), torch.Generator(device=device)
    g_rot.manual_seed(sub_seed(seed, "clusters/rotations"))
    g_flip.manual_seed(sub_seed(seed, "clusters/flips"))
    src = np.repeat(clusters.sources, clusters.sizes)
    for start in range(0, len(src), block):
        dst = torch.from_numpy(clusters.at[start:start + block]).to(device)
        k = len(dst)
        rot = torch.randint(-15, 16, (k,), generator=g_rot, device=device)
        bits = unpack_bits(plane[torch.from_numpy(src[start:start + block]).to(device)])
        bits = bits.reshape(k, ROWS, COLS)
        for r in ROTATIONS:
            at = rot == r
            bits[at] = torch.roll(bits[at], r, dims=2)
        bits = bits.reshape(k, BITS)
        if flip_bits:
            flips = torch.randint(0, BITS, (k, flip_bits), generator=g_flip, device=device)
            bits.scatter_(1, flips, 1 - bits.gather(1, flips))
        plane[dst] = pack_bits(bits)


def make_db(n: int, seed: int, device, clusters: Clusters | None = None,
            flip_bits: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The enrolled DB: packed patterns and masks, uint8 [n, 1600] each, made
    on ``device`` a plane at a time, with any ``clusters`` planted there
    (``flip_bits`` flips in each copy's pattern), and handed over as host
    arrays (the engine takes host arrays); the device copies are freed."""
    out = []
    for plane, flips in (("pattern", flip_bits), ("mask", 0)):
        t = device_planes(n, seed, f"db/{plane}", device)
        if clusters is not None and len(clusters.sources):
            plant_clusters(t, clusters, flips, seed)
        out.append(t.cpu().numpy())
        del t
    return out[0], out[1]


def share_key(seed: int) -> bytes:
    """The keyed party's 32-byte ChaCha20 key."""
    return hashlib.sha256(f"{int(seed)}/share-key".encode()).digest()


def rotate_packed(packed: np.ndarray, amounts: np.ndarray) -> np.ndarray:
    """Rotate packed planes uint8 [k, 1600] by ``amounts[i]`` columns each:
    new column j holds old column (j - amount) mod 200 (``np.roll`` of the
    [64, 200] grid, bit i at [i // 200, i % 200], LSB first)."""
    k = packed.shape[0]
    grid = np.unpackbits(packed, axis=1, bitorder="little").reshape(k, ROWS, COLS)
    cols = (np.arange(COLS)[None, :] - np.asarray(amounts)[:, None]) % COLS
    grid = np.take_along_axis(grid, np.broadcast_to(cols[:, None, :], grid.shape), axis=2)
    return np.packbits(grid.reshape(k, BITS), axis=1, bitorder="little")


@dataclass
class Pool:
    """The distinct requests a closed loop cycles through: request i is
    ``pat[i % P]``, ``msk[i % P]``, uint8 [B, 1600] each. ``source`` is the
    enrolled entry a query copies, or -1 for a fresh template."""

    pat: np.ndarray  # uint8 [P, B, 1600]
    msk: np.ndarray
    source: np.ndarray  # int64 [P, B]

    def __len__(self) -> int:
        return self.pat.shape[0]

    def request(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        p = i % len(self)
        return self.pat[p], self.msk[p]


def make_pool(traffic: dict, seed: int, db: tuple[np.ndarray, np.ndarray] | None,
              clusters: Clusters | None = None) -> Pool:
    """The request pool of a traffic mix: ``distinct_requests`` batches of
    ``batch`` queries; exactly round(``duplicate_share`` x all queries) of
    them, at places drawn from the seed, are copies of enrolled entries
    rotated by -15..15 columns with ``flip_bits`` pattern bits flipped; the
    rest fresh random templates. With ``clusters``, copy k of the first C,
    in request k P / C (the same places for every seed), copies cluster k's
    source unrotated (its copies in the DB are rotated within the 31
    rotations a match tries); the others copy entries outside the clusters
    drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, "traffic"))
    p, b = int(traffic["distinct_requests"]), int(traffic["batch"])
    total = p * b
    pat = rng.integers(0, 256, (total, BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, (total, BITS_BYTES), dtype=np.uint8)
    source = np.full(total, -1, dtype=np.int64)
    n_dup = round(float(traffic.get("duplicate_share", 0)) * total)
    if n_dup:
        if db is None:
            raise ValueError("duplicate queries need an enrolled DB")
        at = rng.choice(total, n_dup, replace=False)
        src = rng.integers(0, db[0].shape[0], n_dup)
        rot = rng.integers(-15, 16, n_dup)
        c = 0 if clusters is None else len(clusters.sources)
        if c:
            if c > n_dup:
                raise ValueError("fewer copies among the queries than clusters")
            # cluster k's query at a fixed place: request k P / C, slot k mod B,
            # so that every seed's window meets each cluster equally often
            fixed = (np.arange(c) * p // c) * b + np.arange(c) % b
            at = np.concatenate([fixed, at[~np.isin(at, fixed)][:n_dup - c]])
            src[:c] = clusters.sources
            rot[:c] = 0
            # the other copies copy no cluster's member, which would draw in
            # a whole cluster as many times as the seed happens to pick one
            free = np.setdiff1d(np.arange(db[0].shape[0]),
                                np.concatenate([clusters.sources, clusters.at]))
            src[c:] = free[src[c:] % len(free)]
        bits = np.unpackbits(rotate_packed(db[0][src], rot), axis=1, bitorder="little")
        flips = np.argsort(rng.random((n_dup, BITS)), axis=1)[:, : int(traffic["flip_bits"])]
        np.put_along_axis(bits, flips, 1 - np.take_along_axis(bits, flips, axis=1), axis=1)
        pat[at] = np.packbits(bits, axis=1, bitorder="little")
        msk[at] = rotate_packed(db[1][src], rot)
        source[at] = src
    return Pool(pat.reshape(p, b, BITS_BYTES), msk.reshape(p, b, BITS_BYTES),
                source.reshape(p, b))
