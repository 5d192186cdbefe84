#!/usr/bin/env python
"""Library-API walkthrough of the PyTorch + CUDA port, mpc_iris_tpu_torch.

The port's CLI roles (examples/quickstart_torch.sh) are thin wrappers over
the library surface shown here:

  1. data types        — Template / Bits / EncodedBits, packed-plane batches,
                         the ring encoding and its inverse
  2. plaintext engine  — min-distance match on the device, f64 parity with
                         the scalar oracle Template.distance
  3. threshold audit   — find_under lists every entry under a threshold;
                         strict <, so t = 0.0 lists nothing
  4. MPC in-process    — share split, per-party ShareEngine dots, wrapping
                         share-sum reconstruction, reference-exact f64 decode,
                         bit-equal to the plaintext engine
  5. keyed party       — a party served from the 32-byte key alone, its
                         share regenerated on the device by ChaCha20
  6. refresh, serving  — pairwise re-randomization keeps the share-sum; a
                         QueryServer over the parties answers the one-shot and
                         the persistent client as the local engine does

Every check is exact (bit-identical f64) and raises on failure. On a card
the match at B <= 8 runs kernel match_packed_small_b, the audit kernel
fractions_packed_small_b and the keyed party kernel share_planes_kernel;
each step prints its host wall time with the device it ran on:

    python examples/api_demo_torch.py                          # the card
    python examples/api_demo_torch.py --device cpu --db 1024   # the CPU

Reference parity: the plaintext path equals Template.distance
(src/template.rs:43-64), the MPC path the reference's encode / share / dot /
decode pipeline (src/lib.rs:16-107, src/encoded_bits.rs:22-38).
"""

import argparse
import asyncio
import time

import numpy as np
import torch

from mpc_iris_tpu_torch import BITS, BITS_BYTES, Bits, EncodedBits, Template, native
from mpc_iris_tpu_torch.models.engines import (
    DEFAULT_CHUNK,
    KeyedShareEngine,
    MasksEngine,
    PlaintextEngine,
    ShareEngine,
)
from mpc_iris_tpu_torch.ops.decode import decode_distance, decode_distance_batch_np
from mpc_iris_tpu_torch.ops.encode import decode_encoded, encode_template
from mpc_iris_tpu_torch.protocol import (
    Coordinator,
    ParticipantServer,
    PersistentQueryClient,
    QueryServer,
    query_remote,
)

N_DB, B, N_PARTIES, CHUNK = 65_536, 8, 3, DEFAULT_CHUNK


def check(cond, what):
    """Exactness checks must survive `python -O` (a bare assert would vanish
    and the demo-as-test would pass vacuously)."""
    if not cond:
        raise RuntimeError(f"api_demo_torch check failed: {what}")


class Steps:
    """Host wall time of each step, ending on a device synchronize."""

    def __init__(self, device: torch.device):
        self.device = device
        self.where = (torch.cuda.get_device_name(device) if device.type == "cuda"
                      else device.type)
        self.ms = {}
        self._t0 = time.perf_counter()

    def done(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.ms[name] = (now - self._t0) * 1e3
        print(f"    {name}: {self.ms[name]:.1f} ms host wall on {self.where}")
        self._t0 = now


def main(argv=None) -> dict:
    """Runs every step; returns each step's host wall time in ms."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (default cuda: the card)")
    ap.add_argument("--db", type=int, default=None, help=f"DB entries (default {N_DB})")
    ap.add_argument("--batch", type=int, default=None, help=f"queries (default {B})")
    args = ap.parse_args(argv)
    n_db = args.db or N_DB
    b = args.batch or B
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("api_demo_torch: --device is CUDA but no CUDA card is available "
                           "(pass --device cpu to run on the CPU)")
    rng = np.random.default_rng(42)
    steps = Steps(dev)

    # ------------------------------------------------- 1. data types
    # A Template is two packed 12,800-bit planes (pattern + valid-bit mask);
    # engines take batch arrays of the packed planes, uint8 [N, 1600].
    print(f"[1] data types: {n_db} templates as packed planes")
    patterns = rng.integers(0, 256, (n_db, BITS_BYTES), dtype=np.uint8)
    masks = rng.integers(0, 256, (n_db, BITS_BYTES), dtype=np.uint8)

    def entry(i) -> Template:
        return Template(Bits(patterns[i]), Bits(masks[i]))

    # Queries: rotated copies of random DB entries, so the expected winner
    # and its distance (0.0, rotation-invariant) are known exactly.
    q_idx = rng.integers(0, n_db, size=b)
    queries = [entry(i).rotated(int(rng.integers(-15, 16))) for i in q_idx]
    qpat = np.stack([t.pattern.data for t in queries])
    qmsk = np.stack([t.mask.data for t in queries])
    check(Template.from_bytes(queries[0].to_bytes()) == queries[0], "3,200-byte wire form")
    enc = encode_template(queries[0])  # the u16 ring vector {0, 1, 0xFFFF}
    check(enc.data.shape == (BITS,) and set(np.unique(enc.data)) <= {0, 1, 0xFFFF},
          "ring encoding values")
    back = decode_encoded(enc)
    check(back.mask == queries[0].mask
          and (back.pattern & back.mask) == (queries[0].pattern & queries[0].mask),
          "decode_encoded inverts encode_template under the mask")
    check(EncodedBits.reconstruct(enc.share(N_PARTIES, rng)) == enc,
          "additive shares reconstruct the encoding")
    print("    wire bytes, ring encoding and its inverse, share/reconstruct exact")
    steps.done("data types")

    # ------------------------------------------------- 2. plaintext engine
    # One pass over the DB per batch: int8 products and the exact
    # integer-fraction argmin on the device, f64 only on the host.
    print(f"[2] PlaintextEngine: {b} queries vs {n_db} templates on {dev}")
    eng = PlaintextEngine(patterns, masks, device=dev, chunk=CHUNK)
    steps.done("plaintext engine build")
    results = eng.match(qpat, qmsk)
    for want, r in zip(q_idx, results):
        check((r.index, r.distance) == (want, 0.0), r)
    check(results[0].distance == queries[0].distance(entry(q_idx[0])),
          "f64 parity with Template.distance (self-match)")
    probe = Template.random(rng)  # a fresh template: its winner is a real distance
    (won,) = eng.match(probe.pattern.data[None], probe.mask.data[None])
    check(won.distance == probe.distance(entry(won.index)) and 0.0 < won.distance < 1.0,
          "f64 parity with Template.distance (fresh query)")
    print(f"    self-match winners exact; a fresh query's winner {won.index} at "
          f"{won.distance!r} equals Template.distance")
    steps.done("match")

    # ------------------------------------------------- 3. threshold audit
    # find_under lists EVERY entry under a threshold with an exact rational
    # compare: a threshold placed exactly ON a distance excludes it.
    print("[3] find_under: dedup audit (exact threshold semantics)")
    audits = eng.find_under(qpat, qmsk, 1e-9)
    for want, hits in zip(q_idx, audits):
        check([m.index for m in hits] == [int(want)], hits)
        check(all(m.distance == 0.0 for m in hits), hits)
    check(eng.find_under(qpat, qmsk, 0.0) == [[]] * b,
          "strict <: t=0.0 excludes exact duplicates")
    print("    each query's planted duplicate listed; t=0.0 lists nothing")
    steps.done("find_under")
    del eng

    # ------------------------------------------------- 4. MPC in-process
    # Secret-share the DB: ring-encode, then split into N_PARTIES additive
    # shares. Shares s < n-1 are addressable ChaCha20 keystreams of `key`
    # (docs/SPEC.md section 4.1); the last carries the data. This is what
    # `prepare` writes to the mpc.share-i files. The key comes from the seeded
    # rng so a failure reproduces (a deployment uses os.urandom(32)).
    print(f"[4] MPC: {N_PARTIES} in-process parties, share-sum reconstruction")
    key = rng.bytes(32)
    enc_db = native.encode_u16_native(patterns, masks)
    shares = native.share_split(enc_db, N_PARTIES, key)  # u16 [n, N_DB, 12800]
    del enc_db
    steps.done("share split (host)")
    # Each party returns dot shares of the public queries against ITS share
    # only; the dot with a public vector is linear, so the wrapping u16 sum of
    # the replies is the encoded dot. The coordinator holds the masks.
    parties = [ShareEngine(shares[p], device=dev, chunk=CHUNK) for p in range(N_PARTIES)]
    masks_eng = MasksEngine(masks, device=dev, chunk=CHUNK)
    steps.done("MPC engines build")
    dots = native.share_sum([p.dots(qpat, qmsk) for p in parties])  # [B, N, 31]
    dens = masks_eng.dots(qmsk)                                     # [B, N, 31]
    dist = decode_distance_batch_np(dots.reshape(-1, 31), dens.reshape(-1, 31)).reshape(b, -1)
    check((dist.argmin(axis=1) == q_idx).all(), "MPC winners == planted")
    for k, r in enumerate(results):
        check(dist[k].min() == r.distance, "MPC f64 == plaintext f64")
    check(decode_distance(dots[0, won.index], dens[0, won.index]) == dist[0, won.index],
          "scalar decode == batched decode")
    print("    MPC distances == plaintext engine distances (bit-exact f64)")
    steps.done("MPC query")

    # ------------------------------------------------- 5. keyed party
    # Party 0's share is pure keystream, so it serves with no share bytes at
    # all: its rows are regenerated on the device from (key, stream 0, row).
    print("[5] KeyedShareEngine: party 0 from the 32-byte key alone")
    keyed = KeyedShareEngine(key, stream_id=0, count=n_db, device=dev, chunk=CHUNK)
    check(np.array_equal(keyed.dots(qpat, qmsk), parties[0].dots(qpat, qmsk)),
          "keyed dots == file-backed dots")
    del keyed
    print("    keyed dots == file-backed dots (byte-identical)")
    steps.done("keyed party")

    # ------------------------------------------------- 6. refresh and serving
    # Parties 0 and 1 refresh their shares with opposite-signed halves of a
    # pairwise zero-sum ChaCha20 stream: each share changes, the sum doesn't.
    print("[6] rerandomize, then the serving stack in-process")
    pair_key = rng.bytes(32)
    s0 = native.rerandomize(shares[0].copy(), pair_key, +1)
    s1 = native.rerandomize(shares[1].copy(), pair_key, -1)
    check(not np.array_equal(s0, shares[0]), "share 0 changed")
    s0 -= shares[0]  # wrapping u16: the sum is unchanged iff the changes cancel
    s1 -= shares[1]
    s0 += s1
    check(not s0.any(), "share-sum unchanged")
    del s0, s1
    print("    shares changed, share-sum unchanged")
    steps.done("rerandomize (host)")

    # The network roles as library objects: the share-holding participants
    # behind a Coordinator, fronted by a QueryServer; clients use the
    # one-shot wire or a persistent session (SPEC 5.2/5.5).
    async def serve_demo():
        servers = [ParticipantServer(p, "127.0.0.1", 0) for p in parties]
        addrs = [await s.start() for s in servers]
        front = QueryServer(Coordinator(masks_eng, addrs, device=dev), "127.0.0.1", 0)
        host, port = await front.start()
        try:
            solo = await query_remote(host, port, queries[0])
            session = await PersistentQueryClient.connect(host, port)
            try:
                o1 = await session.query(queries[0])  # same connection,
                o2 = await session.query(queries[0])  # many queries
            finally:
                await session.close()
            return solo, o1, o2
        finally:
            await front.close()
            for s in servers:
                await s.close()

    solo, o1, o2 = asyncio.run(serve_demo())
    check((solo.index, solo.distance) == (o1.index, o1.distance) == (o2.index, o2.distance),
          "persistent == one-shot outcomes")
    check((solo.index, solo.distance, solo.total) == (results[0].index, results[0].distance,
                                                      n_db),
          "served == local engine")
    print("    one-shot and persistent wires agree with the local engine")
    steps.done("served queries (3)")

    print("api_demo_torch: all checks passed")
    return steps.ms


if __name__ == "__main__":
    main()
