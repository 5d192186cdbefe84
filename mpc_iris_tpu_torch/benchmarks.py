"""Kernel benchmark suite (counterpart of ``mpc_iris_tpu/benchmarks.py``): the
criterion-equivalent of the reference's `cargo bench --bench bench --features
bench` (src/arch/mod.rs:22-72, src/bench.rs).

The reference registers `dot_bool` / `dot_u16` at DB sizes {1, 1k, 31x1k,
100k, 31x100k} element-pairs. This suite times the port's equivalents at the
same points — single-query serving shape (M = 31 rotations) and the batched
shape (B = 128 queries) — plus the match step, the hand-written kernels and
the host-side ETL codecs:

  dot_mask   == dot_bool  (denominator AND-popcount as an int8 product)
  dot_share  == dot_u16   (exact Z_2^16 share dot via the lo/hi int8 pair)
  match_step == engine hot loop (products + the select_chunk kernel)
  match_packed_small_b == the packed small-batch kernel (B = 1, 8)
  chacha_regen == the ChaCha20 share-plane kernel (rows regenerated per s)
  parse/render/share_split/encode == prepare/generate ETL (native C++ core)

Device rows run on the first ``--device`` and are timed by CUDA events, so
no dispatch overhead is subtracted (``dispatch_bound`` is always false); on
a CPU device they are skipped with a note, and the host rows still run.

Run: `python -m mpc_iris_tpu_torch bench-kernels [--json]`.
"""

from __future__ import annotations

import json as _json
import subprocess
import sys
import time

import numpy as np

from mpc_iris_tpu_torch.constants import BITS, N_ROTATIONS

# The reference's criterion size points (element-pairs = DB entries per query-rot).
REFERENCE_SIZES = (1, 1_000, 31_000, 100_000, 3_100_000)

# The card's peaks (NVIDIA H100 SXM data sheet, dense), for the bounds the
# probe runners and chip_smoke.py print: memory, int8 tensor operations, and
# 32-bit ALU instructions on the CUDA cores (the 67 TFLOP/s float32 FMA peak
# counted per instruction).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS = 1.979e15
ALU_OPS = 3.35e13


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    import torch

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


def check_variants(variants, bound_bytes, card: str | None, iters: int = 20) -> bool:
    """A probe runner's loop: each (label, kernel call, plain call) run once,
    its output held against the plain version's bit for bit; with a ``card``
    (the name and limit to print; None on the CPU) also its CUDA-event time,
    and its share of the bound, ``bound_bytes(label)`` at the memory rate.
    Prints a line a variant; returns whether every output was equal."""
    import torch

    ok = True
    for label, kernel, plain in variants:
        got, want = kernel(), plain()
        got, want = ((x,) if torch.is_tensor(x) else tuple(x) for x in (got, want))
        exact = len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
        ok &= exact
        line = f"{label}: {'kernel' if card else 'wrapper'} == plain version: {exact}"
        if card:
            ms = cuda_ms(kernel, iters)
            b_ms = bound_bytes(label) / HBM_BYTES_PER_S * 1e3
            line += (f"; {ms:.4f} ms, {bound_bytes(label) / ms / 1e6:.0f} GB/s, bound "
                     f"{b_ms:.4f} ms (bytes), {b_ms / ms:.1%} of it [{card}]")
        print(line, flush=True)
    return ok


def _timeit(fn, iters=5):
    return _timeit_stats(fn, iters=iters)["min"]


def _timeit_stats(fn, iters=5, cuda: bool = False):
    """Criterion-style sampling (reference src/arch/mod.rs:22-72): warm once,
    take N samples, return robust summary stats (median/MAD/Tukey outliers).
    With ``cuda`` each sample is the device time between two CUDA events."""
    from mpc_iris_tpu_torch.utils.stats import summarize_timings

    fn()
    ts = []
    if cuda:
        import torch

        torch.cuda.synchronize()
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        return summarize_timings(ts)
    for _ in range(iters):
        t0 = time.monotonic()
        fn()
        ts.append(time.monotonic() - t0)
    return summarize_timings(ts)


def _row(name, st, items, macs=None, extra=None) -> dict:
    """One result row (criterion-style: rate from the post-outlier-rejection
    median, dispersion alongside); the row schema of the JAX package's."""
    dt = max(st["median_clean"], 1e-12)
    row = {
        "bench": name,
        "time_s": dt,
        "pairs_per_s": items / dt,
        "tmacs": None if macs is None else macs / dt / 1e12,
        "dispatch_bound": False,
        "mad_s": st["mad"],
        "samples": st["n"],
        "outliers_rejected": st["outliers_rejected"],
    }
    if extra:
        row.update({k: v / dt for k, v in extra.items()})
    return row


def run_device_benches(sizes=REFERENCE_SIZES, batch=128, emit=print, device="cuda"):
    import torch

    from mpc_iris_tpu_torch.models.engines import match_scan_auto
    from mpc_iris_tpu_torch.ops.chacha import key_tensor, share_planes_kernel
    from mpc_iris_tpu_torch.ops.dot import dot_bits_batch, dot_share_batch
    from mpc_iris_tpu_torch.ops.packed_match import match_packed_small_b
    from mpc_iris_tpu_torch.ops.scan import prepare_query_planes

    dev = torch.device(device)
    if dev.type != "cuda":
        emit(f"note: device rows skipped on {dev} (they are timed by CUDA "
             "events on a card; the CPU suite covers their correctness)")
        return []
    if not torch.cuda.is_available():
        raise RuntimeError(f"bench-kernels: --device {device} but no CUDA card is available")
    emit(f"device: {torch.cuda.get_device_name(dev)} (cuda); times by CUDA events")
    results = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def ternary(*shape):
        return torch.randint(-1, 2, shape, dtype=torch.int8, device=dev, generator=gen)

    def bytes_i8(*shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8, device=dev, generator=gen)

    # The reference's criterion points are element-PAIRS (e.g. 31x100k pairs =
    # one query's 31 rotations against 100k entries); DB entries = pairs /
    # LHS rows. Dense int8 [n, 12800] planes cost 12.8 KB each (x2 for the
    # share bench), so cap resident entries well under device memory. The
    # int8 product takes N a multiple of 8 on the card: entries round up.
    cap = 1 << 18  # 262,144 entries = ~3.4 GB/plane

    for label, m_rows in (("q1", N_ROTATIONS), (f"b{batch}", batch * N_ROTATIONS)):
        q = ternary(m_rows, BITS)
        for pairs in sizes:
            n_eff = max(1, min(pairs // m_rows, cap))
            if pairs // max(m_rows, 1) > cap:
                emit(f"note: {label}/{pairs} pairs truncated to {cap} DB entries "
                     "(device memory cap)")
            n_eff = -(-n_eff // 8) * 8
            db = ternary(n_eff, BITS)
            pairs = m_rows * n_eff
            results.append(_row(f"dot_mask/{label}/{n_eff}",
                                _timeit_stats(lambda: dot_bits_batch(q, db), cuda=True),
                                pairs, macs=pairs * BITS))
            lo, hi = bytes_i8(n_eff, BITS), bytes_i8(n_eff, BITS)
            results.append(_row(f"dot_share/{label}/{n_eff}",
                                _timeit_stats(lambda: dot_share_batch(q, lo, hi), cuda=True),
                                pairs, macs=2 * pairs * BITS))
            del lo, hi, db

    # Match step through the select_chunk kernel: throughput-vs-batch curve
    # (latency/throughput tradeoff).
    chunk, n_chunks = 32768, 4
    db = ternary(n_chunks, chunk, BITS)
    dm = (db != 0).to(torch.int8)
    for b in sorted({8, 64, batch}):
        qe = ternary(b, N_ROTATIONS, BITS)
        qm = (qe != 0).to(torch.int8)
        st = _timeit_stats(lambda: match_scan_auto(qe, qm, db, dm), cuda=True)
        cmps = b * n_chunks * chunk * N_ROTATIONS
        results.append(_row(f"match_step/b{b}/{n_chunks * chunk}", st, cmps,
                            macs=2 * cmps * BITS))
    del db, dm

    # Packed small-batch kernel: the B = 1 serving-latency step — bit-plane
    # unpack, both int8 products and the exact selection over a bit-packed
    # DB, one launch.
    rng_np = np.random.default_rng(0)
    pk_pat = torch.from_numpy(
        rng_np.integers(0, 256, (n_chunks, chunk, BITS // 8), dtype=np.uint8)).to(dev)
    pk_msk = torch.from_numpy(
        rng_np.integers(0, 256, (n_chunks, chunk, BITS // 8), dtype=np.uint8)).to(dev)
    for b in (1, 8):
        qp = torch.from_numpy(rng_np.integers(0, 256, (b, BITS // 8), dtype=np.uint8)).to(dev)
        qm_ = torch.from_numpy(rng_np.integers(0, 256, (b, BITS // 8), dtype=np.uint8)).to(dev)
        qe_, qme_ = prepare_query_planes(qp, qm_)
        st = _timeit_stats(lambda: match_packed_small_b(qe_, qme_, pk_pat, pk_msk), cuda=True)
        cmps = b * n_chunks * chunk * N_ROTATIONS
        results.append(_row(f"match_packed_small_b/b{b}/{n_chunks * chunk}", st, cmps,
                            macs=2 * cmps * BITS))
    del pk_pat, pk_msk

    # Keyed-share regeneration: ChaCha20 rows/s through the kernel (the
    # KeyedShareEngine hot path; pairs here = regenerated share rows).
    kw = key_tensor(bytes(32), dev)
    for rows in (4096, 32768):
        st = _timeit_stats(lambda: share_planes_kernel(kw, 0, 0, rows), cuda=True)
        results.append(_row(f"chacha_regen/{rows}", st, rows,  # rows/s
                            extra={"bytes_per_s": rows * 2 * BITS}))
    return results


def run_host_benches(n=2000, emit=print):
    """ETL codec benches (native C++ core with NumPy fallback)."""
    import io

    from mpc_iris_tpu_torch import native

    emit(f"native core: {'C++' if native.available() else 'NumPy fallback'}")
    rng = np.random.default_rng(0)
    pats = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msks = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    results = []

    dt = _timeit(lambda: native.render_templates(pats, msks))
    results.append({"bench": f"etl/render/{n}", "time_s": dt, "items_per_s": n / dt})

    blob = b"[" + native.render_templates(pats, msks) + b"]\n"

    def parse():
        for _ in native.parse_templates_stream(io.BytesIO(blob)):
            pass
    dt = _timeit(parse)
    results.append({"bench": f"etl/parse/{n}", "time_s": dt, "items_per_s": n / dt})

    enc = native.encode_u16_native(pats, msks)
    dt = _timeit(lambda: native.share_split(enc[:256], 3,
                                            native.derive_insecure_key(1)))
    results.append({"bench": "etl/share_split3/256", "time_s": dt,
                    "items_per_s": 256 / dt})

    dt = _timeit(lambda: native.encode_u16_native(pats, msks))
    results.append({"bench": f"etl/encode/{n}", "time_s": dt, "items_per_s": n / dt})
    return results


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="bench-kernels")
    p.add_argument("--json", action="store_true", help="one JSON line per bench")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--sizes", type=int, nargs="*", default=list(REFERENCE_SIZES))
    p.add_argument("--host-only", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the device rows' device (first of a list)")
    args = p.parse_args(argv)

    emit = (lambda *a: print(*a, file=sys.stderr)) if args.json else print
    results = []
    if not args.host_only:
        results += run_device_benches(sizes=args.sizes, batch=args.batch, emit=emit,
                                      device=args.device.split(",")[0].strip())
    results += run_host_benches(emit=emit)

    if args.json:
        for r in results:
            print(_json.dumps(r))
    else:
        for r in results:
            rate = r.get("pairs_per_s") or r.get("items_per_s")
            disp = (f" ±{r['mad_s']*1e3:.2f}" if r.get("mad_s") is not None
                    else "")
            extra = (f"  {r['tmacs']:7.1f} TMAC/s"
                     if r.get("tmacs") is not None else "")
            print(f"{r['bench']:32s} {r['time_s']*1e3:10.2f}{disp} ms   "
                  f"{rate:14.3e} /s{extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
