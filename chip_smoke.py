#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's plaintext match and threshold-audit paths
once on one NVIDIA GPU, at full size, and check them.

- builds the CUDA kernels from mpc_iris_tpu_torch/csrc with nvcc (sm_90a);
- serves match requests through ``PlaintextEngine.match``: B = 1 and 8 on a
  1,048,576-entry packed DB (kernel match_packed_small_b), B = 13 and 128 on
  the same DB and B = 128 on a 262,144-entry dense DB (kernel select_chunk);
- holds every winner against the plain path on the card, bit for bit; the
  planted self-matches (rotated copies of DB entries) at distance 0.0, and a
  duplicated entry at its lower index; and ``distances()`` against the scalar
  oracle ``Template.distance`` for 2 queries x 256 sampled entries;
- serves audit requests on the same engines: ``min_fractions`` at B = 1 and 8
  (kernel fractions_packed_small_b), bit-equal to the plain spectrum and, on
  sampled entries, to ``Template.distance``; ``find_under`` at threshold
  0.375 for packed B = 1, 8 (the kernel plus the device compaction) and 13
  (the spectrum scan) and dense B = 8, each list equal to the plain
  spectrum's; and one threshold with about 1,000 entries under it, past a
  256-entry compact buffer, equal to the full path, with a ``limit`` that
  must raise;
- counts the kernel launches of each path's run, and times each request and
  each kernel beside its plain version, labelled with the card's name and
  limit.

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
from mpc_iris_tpu_torch.models.engines import (
    AuditLimitExceeded,
    PlaintextEngine,
    _compact_under_device,
    _match_scan,
    find_under_from_fractions,
)
from mpc_iris_tpu_torch.ops import _build
from mpc_iris_tpu_torch.ops.decode import fractions_to_f64_np, under_threshold_mask_np
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch
from mpc_iris_tpu_torch.ops.packed_match import (
    fractions_packed_small_b,
    fractions_packed_small_b_reference,
    match_packed_small_b,
    match_packed_small_b_reference,
)
from mpc_iris_tpu_torch.ops.scan import (
    _fractions_scan,
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
# the audit: the reference bench.py's audit threshold; the overflow case's
# rank and compact buffer
AUDIT_THRESHOLD = 0.375
OVERFLOW_RANK = 1000
OVERFLOW_K = 256


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


def rows(lists):
    return [[(m.index, m.distance, m.numerator, m.denominator) for m in row] for row in lists]


def host_spectrum(nd: torch.Tensor, count: int) -> np.ndarray:
    return nd[:, :, :count].cpu().numpy().astype(np.uint16)


def overflow_threshold(nd: np.ndarray):
    """From one query's uint16 [2, N] spectrum: the f64 distance t of the
    entry at rank OVERFLOW_RANK, or the first after it whose exact fraction
    is not under its own f64 value, so that strict < excludes it. Returns
    (t, entry, its rank); at most that many entries lie under t."""
    dist = fractions_to_f64_np(nd[0], nd[1])
    order = np.argsort(dist, kind="stable")
    for rank in range(OVERFLOW_RANK, order.size):
        e = int(order[rank])
        t = float(dist[e])
        if not under_threshold_mask_np(nd[0, e:e + 1], nd[1, e:e + 1], t)[0]:
            return t, e, rank
    raise RuntimeError("no overflow threshold found")


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
                                       "packed_fractions_kernel", "fold_parts_kernel")
                               if k in line), line)
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

    counted = (select_chunk, match_packed_small_b, fractions_packed_small_b)

    # ---- the match path, counted
    for fn in counted:
        fn.launches = 0
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

    # ---- the audit path: plain spectra first (torch ops, no kernel launch);
    # the packed one is the spectrum scan the engine itself runs at B = 13
    q_over = slice(N_PLANTED, N_PLANTED + 1)  # a random query
    plain = {bb: host_spectrum(fractions_packed_small_b_reference(
        *planes(qpat[:bb], qmsk[:bb], dev), packed.db_pat, packed.db_msk), packed.count)
        for bb in (1, 8, 13)}
    plain_dense = host_spectrum(_fractions_scan(
        *planes(dqpat[:8], dqmsk[:8], dev), dense.db_enc, dense.db_mask), dense.count)
    t_over, e_over, rank_over = overflow_threshold(plain[13][:, N_PLANTED])

    audit_requests = [("packed", packed, 1, qpat, qmsk), ("packed", packed, 8, qpat, qmsk),
                      ("packed", packed, 13, qpat, qmsk), ("dense", dense, 8, dqpat, dqmsk)]

    # ---- the audit path, counted
    for fn in counted:
        fn.launches = 0
    spectra = {bb: packed.min_fractions(qpat[:bb], qmsk[:bb]) for bb in (1, 8)}
    audits = [eng.find_under(qp[:bb], qm[:bb], AUDIT_THRESHOLD)
              for _, eng, bb, qp, qm in audit_requests]
    over = packed.find_under(qpat[q_over], qmsk[q_over], t_over, compact_k=OVERFLOW_K)
    over_compacted = packed.find_under(qpat[q_over], qmsk[q_over], t_over)
    try:
        packed.find_under(qpat[q_over], qmsk[q_over], t_over, limit=OVERFLOW_RANK // 2)
        limit_raised = False
    except AuditLimitExceeded:
        limit_raised = True
    audit_launches = {fn.__name__: fn.launches for fn in counted}
    print(f"launches in the audit-path run: {json.dumps(audit_launches)}")
    check(audit_launches["fractions_packed_small_b"] > 0,
          "fractions_packed_small_b launched on the audit path")
    launches["fractions_packed_small_b"] = audit_launches["fractions_packed_small_b"]

    # ---- correctness of every audit request
    for bb, nd in spectra.items():
        check(nd.dtype == np.uint16 and np.array_equal(nd, plain[bb]),
              f"min_fractions packed B={bb}: spectrum bit-equal to the plain version")
    for j in range(N_PLANTED):
        for e in np.concatenate([[planted[j], dup], rng.choice(PACKED_DB, 6, replace=False)]):
            want = Template(Bits(qpat[j]), Bits(qmsk[j])).distance(
                Template(Bits(pat[e]), Bits(msk[e])))
            got = float(fractions_to_f64_np(spectra[8][0, j, e], spectra[8][1, j, e]))
            check(got == want, f"min_fractions[{j}, {e}] == Template.distance "
                  f"({got!r} vs {want!r})")
    print("min_fractions packed B=1, 8: spectra bit-equal to the plain version; "
          "8 x 8 sampled entries equal Template.distance")
    for (storage, eng, bb, qp, qm), res in zip(audit_requests, audits):
        want = plain_dense if eng is dense else plain[bb]
        check(rows(res) == rows(find_under_from_fractions(want, AUDIT_THRESHOLD)),
              f"find_under {storage} B={bb}: lists equal the plain spectrum's")
        pl, dp = (planted, dup) if eng is packed else (dplanted, ddup)
        for j in range(min(bb, N_PLANTED)):
            check((int(pl[j]), 0.0) in [(m.index, m.distance) for m in res[j]],
                  f"find_under {storage} B={bb}: planted {pl[j]} listed at 0.0")
        check([(m.index, m.distance) for m in res[0][:2]] == [(pl[0], 0.0), (dp, 0.0)],
              f"find_under {storage} B={bb}: duplicate {dp} after its twin {pl[0]}")
        print(f"audit {storage} B={bb} t={AUDIT_THRESHOLD}: lists equal the plain "
              f"spectrum's; {sum(map(len, res))} hits, planted self-matches at 0.0, "
              f"duplicate {pl[0]}/{dp} in index order")
    full = find_under_from_fractions(plain[13][:, q_over], t_over)
    n_over = len(full[0])
    meta, _ = _compact_under_device(
        torch.from_numpy(plain[13][:, q_over].astype(np.int16)).to(dev),
        np.float32(t_over * (1.0 + 1e-4)), OVERFLOW_K)
    check(int(meta[0, 0]) > OVERFLOW_K, "overflow case: candidates exceed the compact buffer")
    check(OVERFLOW_K < n_over <= rank_over, f"overflow case: {n_over} entries under t")
    check(rows(over) == rows(full) == rows(over_compacted),
          f"overflow case: compact_k={OVERFLOW_K} (full-spectrum fallback) equals the "
          "full path and the compacted path")
    check(e_over not in [m.index for m in over[0]], "overflow case: the entry at t excluded")
    check(limit_raised, f"overflow case: limit {OVERFLOW_RANK // 2} raises")
    print(f"audit overflow t={t_over!r} (rank {rank_over}): {n_over} hits, "
          f"{int(meta[0, 0])} candidates > "
          f"compact_k {OVERFLOW_K}; equal to the full path; entry {e_over} at t excluded; "
          f"limit {OVERFLOW_RANK // 2} raised")

    # ---- times (launches from here on are not counted above)
    for (storage, eng, bb, qp, qm) in requests:
        ms = wall_ms(lambda: eng.match(qp[:bb], qm[:bb]), 3)
        print(f"time request {storage} N={eng.count} B={bb}: {ms:.3f} ms "
              f"(median of 3, host wall) [{card}]")
    for (storage, eng, bb, qp, qm) in audit_requests:
        ms = wall_ms(lambda: eng.find_under(qp[:bb], qm[:bb], AUDIT_THRESHOLD), 3)
        print(f"time request find_under {storage} N={eng.count} B={bb} "
              f"t={AUDIT_THRESHOLD}: {ms:.3f} ms (median of 3, host wall) [{card}]")

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

    # (c) fractions_packed_small_b over the whole packed DB, beside its plain
    # version; and the compaction of its B = 8 spectrum
    c_rows = {}
    for bb in (1, 8, 16):
        args4 = (q_enc[:bb], q_mask[:bb], packed.db_pat, packed.db_msk)
        got = fractions_packed_small_b(*args4)
        want = fractions_packed_small_b_reference(*args4)
        err = int((got.int() - want.int()).abs().max())
        check(err == 0, f"fractions_packed_small_b B={bb}: kernel equals plain version")
        k_ms = cuda_ms(lambda: fractions_packed_small_b(*args4), 5)
        p_ms = cuda_ms(lambda: fractions_packed_small_b_reference(*args4), 2)
        c_rows[bb] = (err, k_ms, p_ms)
        print(f"time kernel fractions_packed_small_b N={packed.count} B={bb}: "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms [{card}]")
        if bb == 8:
            t_hi, k = np.float32(AUDIT_THRESHOLD * (1.0 + 1e-4)), 65536
            c_ms = cuda_ms(lambda: _compact_under_device(got, t_hi, k), 20)
            print(f"time compaction _compact_under_device [2, 8, {got.shape[2]}] k={k}: "
                  f"{c_ms:.3f} ms (CUDA events; includes the host sync of nonzero) "
                  f"[{card}]")
    err, k_ms, p_ms = c_rows[8]
    kernels.append({"name": "fractions_packed_small_b", "route": "cuda",
                    "source": "mpc_iris_tpu_torch/csrc/packed_fractions.cu",
                    "replaces": "mpc_iris_tpu/ops/packed_match.py:227",
                    "launches": launches["fractions_packed_small_b"], "max_abs_err": err,
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
