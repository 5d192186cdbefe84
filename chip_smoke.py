#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's plaintext match path once on one NVIDIA
GPU, at full size, and check it.

- builds the CUDA kernels from mpc_iris_tpu_torch/csrc with nvcc (sm_90a);
- serves match requests through ``PlaintextEngine.match``: B = 1 and 8 on a
  1,048,576-entry packed DB (kernel match_packed_small_b), B = 13 and 128 on
  the same DB and B = 128 on a 262,144-entry dense DB (kernel select_chunk);
- holds every winner against the plain path on the card, bit for bit; the
  planted self-matches (rotated copies of DB entries) at distance 0.0, and a
  duplicated entry at its lower index; and ``distances()`` against the scalar
  oracle ``Template.distance`` for 2 queries x 256 sampled entries;
- counts the kernel launches of that run, and times each request and each
  kernel beside its plain version, labelled with the card's name and limit.

The last line is ``{"ok": true, "device": {...}}``; the line before it is the
kernels as JSON. Exits nonzero, printing no result, without a CUDA card or
when any build, launch or check fails.

    python3 chip_smoke.py [--seed S]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from mpc_iris_tpu_torch import BITS_BYTES, Bits, Template
from mpc_iris_tpu_torch.models.engines import PlaintextEngine, _match_scan
from mpc_iris_tpu_torch.ops import _build
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch
from mpc_iris_tpu_torch.ops.packed_match import (
    match_packed_small_b,
    match_packed_small_b_reference,
)
from mpc_iris_tpu_torch.ops.scan import (
    _fused_rows,
    _match_scan_packed,
    _unpack_encode_chunk,
    prepare_query_planes,
)
from mpc_iris_tpu_torch.ops.select import select_chunk, select_chunk_reference

# DB sizes: the packed and dense defaults of the reference's bench.py
PACKED_DB = 1_048_576
DENSE_DB = 262_144
N_PLANTED = 8


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def make_db(rng: np.random.Generator, n: int):
    """Random packed DB uint8 [n, 1600] x2 with 8 planted entries, whose
    rotated copies are the first 8 queries, and planted[0] duplicated at a
    higher index in another chunk, congruent to it mod 128."""
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


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Median host wall time of ``fn`` (which returns host data, so ends
    synchronized) over ``reps`` calls after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def planes(qp: np.ndarray, qm: np.ndarray, dev: torch.device):
    return prepare_query_planes(torch.from_numpy(qp).to(dev), torch.from_numpy(qm).to(dev))


def triples(results) -> torch.Tensor:
    return torch.tensor([[r.numerator for r in results], [r.denominator for r in results],
                         [r.index for r in results]], dtype=torch.int32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    b = _build.build()
    sources = ", ".join(str(p.relative_to(_build.CSRC.parent.parent))
                        for p in _build.sources())
    took = f"in {b.seconds:.2f} s" if b.seconds else "(reused, same sources)"
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS[:2])} {sources} -> "
          f"{b.path.name} {took}")
    kernel = "?"
    for line in b.log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("select_part_kernel", "packed_part_kernel",
                                       "fold_parts_kernel") if k in line), line)
        elif "Used" in line:
            print(f"  ptxas {kernel}: {line.split(':', 1)[1].strip()}")

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    pat, msk, planted, dup, qpat, qmsk = make_db(rng, PACKED_DB)
    dpat, dmsk, dplanted, ddup, dqpat, dqmsk = make_db(rng, DENSE_DB)
    print(f"data: packed DB {PACKED_DB} entries, dense DB {DENSE_DB} entries, "
          f"seed {args.seed}, made in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    packed = PlaintextEngine(pat, msk, device=dev, storage="packed")
    dense = PlaintextEngine(dpat, dmsk, device=dev, storage="dense")
    torch.cuda.synchronize()
    print(f"engines: packed chunk {packed.chunk}, dense chunk {dense.chunk}, built "
          f"(upload, unpack, kernel canary) in {time.perf_counter() - t0:.1f} s; "
          f"device memory {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")

    requests = [("packed", packed, 1, qpat, qmsk), ("packed", packed, 8, qpat, qmsk),
                ("packed", packed, 13, qpat, qmsk), ("packed", packed, 128, qpat, qmsk),
                ("dense", dense, 128, dqpat, dqmsk)]

    # ---- the main path, counted
    select_chunk.launches = 0
    match_packed_small_b.launches = 0
    served = [eng.match(qp[:bb], qm[:bb]) for _, eng, bb, qp, qm in requests]
    launches = {"select_chunk": select_chunk.launches,
                "match_packed_small_b": match_packed_small_b.launches}
    print(f"launches in the main-path run: {json.dumps(launches)}")
    check(all(v > 0 for v in launches.values()), "every kernel launched on the main path")

    # ---- correctness of every request
    for (storage, eng, bb, qp, qm), res in zip(requests, served):
        q_enc, q_mask = planes(qp[:bb], qm[:bb], dev)
        if storage == "dense":
            plain = _match_scan(q_enc, q_mask, eng.db_enc, eng.db_mask)
        elif bb <= 8:
            plain = match_packed_small_b_reference(q_enc, q_mask, eng.db_pat, eng.db_msk)
        else:
            plain = _match_scan_packed(q_enc, q_mask, eng.db_pat, eng.db_msk, fused=False)
        check(torch.equal(triples(res), plain.cpu()),
              f"{storage} B={bb}: winners equal the plain path on the card")
        pl, dp = (planted, dup) if eng is packed else (dplanted, ddup)
        for j in range(min(bb, N_PLANTED)):
            check(res[j].index == pl[j] and res[j].distance == 0.0,
                  f"{storage} B={bb}: planted query {j} -> entry {pl[j]} at 0.0, "
                  f"got {res[j]}")
        print(f"request {storage} B={bb}: winners equal the plain path; planted "
              f"self-matches at 0.0; duplicate {pl[0]}/{dp} -> {res[0].index}")

    for name, eng, db_pat, db_msk, qp, qm, pl, dp in (
            ("packed", packed, pat, msk, qpat, qmsk, planted, dup),
            ("dense", dense, dpat, dmsk, dqpat, dqmsk, dplanted, ddup)):
        q = [0, N_PLANTED]  # a planted query and a random one
        dist = eng.distances(qp[q], qm[q])
        check(dist.shape == (2, db_pat.shape[0]), f"{name}: distances shape")
        sample = np.concatenate([[pl[0], dp], rng.choice(db_pat.shape[0], 254, replace=False)])
        for row, qi in enumerate(q):
            qt = Template(Bits(qp[qi]), Bits(qm[qi]))
            for e in sample:
                want = qt.distance(Template(Bits(db_pat[e]), Bits(db_msk[e])))
                check(dist[row, e] == want, f"{name}: distances[{qi}, {e}] == "
                      f"Template.distance ({dist[row, e]!r} vs {want!r})")
        check(np.isfinite(dist[1]).all() and dist[0, pl[0]] == 0.0, f"{name}: distances")
        print(f"distances {name}: 2 x 256 sampled pairs equal Template.distance")

    # ---- times (launches from here on are not counted above)
    for (storage, eng, bb, qp, qm) in requests:
        ms = wall_ms(lambda: eng.match(qp[:bb], qm[:bb]), 3)
        print(f"time request {storage} N={eng.count} B={bb}: {ms:.3f} ms "
              f"(median of 3, host wall) [{card}]")

    kernels = []
    # (a) select_chunk at the packed scan's shapes: one chunk's products
    q_enc, q_mask = planes(qpat, qmsk, dev)
    enc0, m0 = _unpack_encode_chunk(packed.db_pat[0], packed.db_msk[0])
    a_rows = {}
    for bb in (13, 128):
        dot = dot_bits_batch(_fused_rows(q_enc[:bb]), enc0)
        den = dot_bits_batch(_fused_rows(q_mask[:bb]), m0)
        got = torch.stack(select_chunk(dot, den, 0))
        want = torch.stack(select_chunk_reference(dot, den, 0))
        err = int((got - want).abs().max())
        check(err == 0, f"select_chunk B={bb}: kernel equals plain version")
        k_ms = cuda_ms(lambda: select_chunk(dot, den, 0), 20)
        p_ms = cuda_ms(lambda: select_chunk_reference(dot, den, 0), 3)
        a_rows[bb] = (err, k_ms, p_ms)
        print(f"time kernel select_chunk [{bb * 32}, {packed.chunk}] int32: {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms [{card}]")
    err, k_ms, p_ms = a_rows[128]
    kernels.append({"name": "select_chunk", "route": "cuda",
                    "source": "mpc_iris_tpu_torch/csrc/select_chunk.cu",
                    "replaces": "mpc_iris_tpu/ops/select_pallas.py:156",
                    "launches": launches["select_chunk"], "max_abs_err": err,
                    "ms": k_ms, "plain_ms": p_ms})

    # (b) match_packed_small_b over the whole packed DB; beside it the scan
    # through (a), the other side of the dispatch boundary, at batches on
    # both sides of it
    b_rows = {}
    for bb in (1, 8, 16, 24, 32):
        args4 = (q_enc[:bb], q_mask[:bb], packed.db_pat, packed.db_msk)
        got = match_packed_small_b(*args4)
        want = match_packed_small_b_reference(*args4)
        err = int((got - want).abs().max())
        check(err == 0, f"match_packed_small_b B={bb}: kernel equals plain version")
        k_ms = cuda_ms(lambda: match_packed_small_b(*args4), 5)
        p_ms = cuda_ms(lambda: match_packed_small_b_reference(*args4), 2)
        s_ms = cuda_ms(lambda: _match_scan_packed(*args4, fused=True), 2)
        b_rows[bb] = (err, k_ms, p_ms)
        print(f"time kernel match_packed_small_b N={packed.count} B={bb}: {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms, packed scan through select_chunk {s_ms:.3f} ms "
              f"[{card}]")
    err, k_ms, p_ms = b_rows[8]
    kernels.append({"name": "match_packed_small_b", "route": "cuda",
                    "source": "mpc_iris_tpu_torch/csrc/packed_match.cu",
                    "replaces": "mpc_iris_tpu/ops/packed_match.py:114",
                    "launches": launches["match_packed_small_b"], "max_abs_err": err,
                    "ms": k_ms, "plain_ms": p_ms})

    check("jax" not in sys.modules, "no jax imported")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
