"""Probe matrix of the fused ChaCha20-regeneration + share-product question
on an NVIDIA GPU: the PyTorch + CUDA counterpart of
scripts/fused_mm_regen_probe.py (which measured the TPU families and wrote
docs/FUSED_REGEN_MATRIX.json).

The question: does one kernel that regenerates a keyed party's share rows
from the key and multiplies them in place beat the engines' two stages
(kernel (d) writes the lo/hi planes to device memory, then the products read
them back)? Families, each in its own subprocess so that a CUDA fault cannot
poison the next:

  library       the engines' path: kernel (d) ``share_planes_kernel``, then
                ``dot_share_batch`` (``torch._int_mm``); a product alone is
                ``torch._int_mm``
  gemm          ``int8_gemm`` (csrc/int8_gemm.cu), the counterpart of the TPU
                families wholek-pallas, grid-k and slab; a keyed chunk is
                kernel (d), then the share products through ``int8_gemm``
  fused-serial  ``keyed_share_dots(variant="serial")`` (csrc/keyed_share_dot.cu)
  fused-pipe    ``keyed_share_dots(variant="pipelined")``, warp-specialized

Configurations: products int8 [M, 12,800] . [rows, 12,800]^T at M = 31 B
for the engine's B = 1, 8 and the TPU matrix's B = 64, 256, and M = 4,096
(the scan's products of a B = 128 request); keyed chunks of ``rows`` share
rows (16,384, the engines' chunk) at B = 1, 8, 64, 256, from a row offset
whose u64 nonce carries in mid-chunk. Each record holds its check against
the plain version (bit for bit), CUDA-event ms, TMAC/s and the bound (the
larger of the bytes at 3.35 TB/s, the int8 operations at 1,979 TOPS and, for
a keyed chunk, ChaCha20's 976 int32 operations a 64-byte block at 3.35e13/s),
with the card's name and power limit. On the card the matrix goes to
docs/FUSED_REGEN_MATRIX_torch.json. ``--device cpu`` rehearses the control
flow and the checks through the plain versions, with no times.

    python scripts/fused_mm_regen_probe_torch.py            # on the card
    python scripts/fused_mm_regen_probe_torch.py --device cpu --rows 64 \\
        --batches 1 --product-rows 31 --out /tmp/matrix.json
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mpc_iris_tpu_torch.constants import BITS  # noqa: E402
from mpc_iris_tpu_torch.ops.chacha import key_tensor  # noqa: E402
from mpc_iris_tpu_torch.ops.gemm import int8_gemm, int8_gemm_reference  # noqa: E402
from mpc_iris_tpu_torch.ops.keyed_dot import (  # noqa: E402
    FAMILIES,
    keyed_share_dots_reference,
    share_dots_chunk,
)

OUT = os.path.join(REPO, "docs", "FUSED_REGEN_MATRIX_torch.json")
# the card's peaks (NVIDIA H100 SXM data sheet, dense): memory, int8 tensor
# operations, 32-bit ALU instructions (the 67 TFLOP/s float32 peak per
# instruction); ChaCha20's int32 operations a 64-byte block
HBM_BYTES_PER_S = 3.35e12
INT8_OPS = 1.979e15
ALU_OPS = 3.35e13
CHACHA_OPS = 20 * 4 * 12 + 16
KEY = bytes(range(0x80, 0xA0))  # high bits set
STREAM_ID = 0xFFFFFFFE
SEED = 0
REPS = 10  # timed calls after a warm-up
FAMILY_TIMEOUT_S = 600  # the first family builds the kernels


def bound(n_bytes: float, ops: float, alu_ops: float = 0.0):
    """(ms, what): the least time the card could take for the work."""
    times = {"bytes": n_bytes / HBM_BYTES_PER_S, "operations": ops / INT8_OPS,
             "alu operations": alu_ops / ALU_OPS}
    what = max(times, key=times.get)
    return times[what] * 1e3, what


def card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name, limit = (v.strip() for v in out.split(",", 1))
    return {"name": name, "power_limit": limit, "torch_name": torch.cuda.get_device_name(0)}


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls by CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def product_records(family: str, dev, rows: int, product_rows):
    rng = np.random.default_rng(SEED)
    db = torch.from_numpy(rng.integers(-128, 128, (rows, BITS), dtype=np.int8)).to(dev)
    for m in product_rows:
        q = torch.from_numpy(rng.integers(-1, 2, (m, BITS), dtype=np.int8)).to(dev)
        fn = (lambda: int8_gemm(q, db)) if family == "gemm" else (lambda: torch._int_mm(q, db.T))
        err = int((fn().to(torch.int64) - int8_gemm_reference(q, db)).abs().max())
        rec = {"kind": "product", "m": m, "n": rows, "k": BITS, "max_abs_err": err}
        if dev.type == "cuda":
            ms = cuda_ms(fn, REPS)
            b_ms, b_by = bound(m * BITS + rows * BITS + 4 * m * rows, 2 * m * rows * BITS)
            rec.update(ms=ms, tmacs=m * rows * BITS / ms / 1e9, bound_ms=b_ms, bound_by=b_by)
        yield rec


def keyed_records(family: str, dev, rows: int, batches):
    rng = np.random.default_rng(SEED + 1)
    kw = key_tensor(KEY, dev)
    row0 = 2**32 - rows // 2  # the u64 nonce carries in mid-chunk
    for b in batches:
        m = 31 * b
        q = torch.from_numpy(rng.integers(-1, 2, (m, BITS), dtype=np.int8)).to(dev)

        def fn():
            return share_dots_chunk(family, q, kw, STREAM_ID, row0, rows)

        got = fn()
        want = keyed_share_dots_reference(q, kw, STREAM_ID, row0, rows)
        err = int((got - want).abs().max())
        rec = {"kind": "keyed-chunk", "batch": b, "m": m, "n": rows, "k": BITS,
               "row0": row0, "stream_id": STREAM_ID, "max_abs_err": err,
               "checksum": int(got.sum(dtype=torch.int64)) & 0xFFFFFFFF}
        del got, want
        if dev.type == "cuda":
            ms = cuda_ms(fn, REPS)
            b_ms, b_by = bound(m * BITS + 4 * m * rows + 32, 2 * 2 * m * rows * BITS,
                               rows * (BITS // 32) * CHACHA_OPS)
            rec.update(ms=ms, tmacs=2 * m * rows * BITS / ms / 1e9, bound_ms=b_ms,
                       bound_by=b_by)
        yield rec


def child(args) -> int:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card available", file=sys.stderr)
        return 1
    info = card() if dev.type == "cuda" else {"name": "cpu (no times)"}
    records = keyed_records(args.child, dev, args.rows, args.batches)
    if args.child in ("library", "gemm"):
        records = itertools.chain(
            product_records(args.child, dev, args.rows, args.product_rows), records)
    for rec in records:  # each printed as it comes: a fault keeps the ones before it
        rec.update(family=args.child, device=str(dev), card=info)
        print(json.dumps(rec), flush=True)
    return 0


def ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",") if v]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=16_384, help="share rows a chunk; DB rows of a product")
    ap.add_argument("--batches", type=ints, default=[1, 8, 64, 256])
    ap.add_argument("--product-rows", type=ints, default=[31, 248, 1984, 4096, 7936])
    ap.add_argument("--out", default=None,
                    help=f"where the matrix goes (default on the card: {OUT}; on the CPU: nowhere)")
    ap.add_argument("--child", choices=FAMILIES, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args)

    out = args.out or (OUT if torch.device(args.device).type == "cuda" else None)
    passed = ["--device", args.device, "--rows", str(args.rows),
              "--batches", ",".join(map(str, args.batches)),
              "--product-rows", ",".join(map(str, args.product_rows))]
    results, ok = [], True
    for family in FAMILIES:
        t0 = time.monotonic()
        print(f"[run  ] {family} ...", flush=True)
        try:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), *passed,
                                   "--child", family], capture_output=True, text=True,
                                  timeout=FAMILY_TIMEOUT_S)
            recs = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
            outcome = "ok" if proc.returncode == 0 else f"failed-rc{proc.returncode}"
            tail = None if proc.returncode == 0 else (proc.stdout + proc.stderr)[-2000:]
        except subprocess.TimeoutExpired:
            recs, outcome, tail = [], "timeout", None
        wrong = [r for r in recs if r["max_abs_err"] != 0]
        if wrong:
            outcome = "wrong"
        ok &= outcome == "ok"
        results.append({"family": family, "outcome": outcome,
                        "wall_s": time.monotonic() - t0, "tail": tail, "records": recs})
        print(f"[done ] {family}: {outcome}, {len(recs)} records", flush=True)
        if tail:
            print(tail, file=sys.stderr)
        for r in recs:
            what = f"M={r['m']}" if r["kind"] == "product" else f"B={r['batch']}"
            times = (f"{r['ms']:.4f} ms, {r['tmacs']:.1f} TMAC/s, bound {r['bound_ms']:.4f} ms "
                     f"({r['bound_by']})" if "ms" in r else "not timed")
            print(f"  {family:<12} {r['kind']:<11} {what:<7} err {r['max_abs_err']}  {times}")

    # every family's chunk dots must agree (each already equals the plain version)
    sums = {}
    for res in results:
        for r in res["records"]:
            if r["kind"] == "keyed-chunk":
                sums.setdefault(r["batch"], set()).add(r["checksum"])
    agree = all(len(v) == 1 for v in sums.values())
    print(f"keyed-chunk checksums agree across families: {agree}")
    ok &= agree
    doc = {
        "question": "does one kernel that regenerates the keyed share rows (ChaCha20) "
                    "and multiplies them in place beat kernel (d) followed by the share "
                    "products, on this card?",
        "script": "scripts/fused_mm_regen_probe_torch.py",
        "date": time.strftime("%Y-%m-%d"),
        "families": results,
    }
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
