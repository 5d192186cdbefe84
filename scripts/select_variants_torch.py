"""Compare-op variants of the fused select kernel on an NVIDIA GPU: the
PyTorch + CUDA counterpart of scripts/select_variants.py.

  i32        int32 cross products (kernel (a)'s compare)
  f32        float32 cross products (INEXACT past 2^24)
  f32_exact  float32 split-exact cross products (d = 128 d_hi + d_lo)

Each is ``select_variant`` (csrc/select_probes.cu), the probe's keep-first
trees pairing for pairing, on the probe's inputs: b = 128 queries of 32
rows over n = 32,768 columns, int32 dot and den (1.07 GB), den and num
uniform in [0, 12,800], made on the device from ``--seed``. Per compare: the
kernel against its plain version run on the same device (bit for bit),
whether it equals the i32 variant (as the probe prints), its CUDA-event
time beside kernel (a) ``select_chunk`` on the same inputs, and its bound
(the bytes read once at 3.35 TB/s), with the card's name and power limit.
``--device cpu`` rehearses at a small size (``--b 8 --n 4096``) and prints no
times.

    python scripts/select_variants_torch.py
    python scripts/select_variants_torch.py --device cpu --b 8 --n 4096
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mpc_iris_tpu_torch.benchmarks import HBM_BYTES_PER_S, card_line, cuda_ms  # noqa: E402
from mpc_iris_tpu_torch.ops.select import select_chunk  # noqa: E402
from mpc_iris_tpu_torch.ops.select_probes import (  # noqa: E402
    COMPARES,
    select_variant,
    select_variant_reference,
)
from mpc_iris_tpu_torch.smoke_data import probe_inputs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--b", type=int, default=128, help="queries (a multiple of 8)")
    ap.add_argument("--n", type=int, default=32_768, help="columns (a multiple of 2,048)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device(args.device)
    timed = dev.type == "cuda"
    if timed and not torch.cuda.is_available():
        print("select_variants_torch: no CUDA card available", file=sys.stderr)
        return 1
    name = card_line() if timed else "cpu (no times)"
    dot, den = probe_inputs(args.b, args.n, args.seed, dev)
    bound = 2 * dot.numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(f"inputs int32 [{args.b * 32}, {args.n}] x2 on {dev} [{name}]")
    if timed:
        print(f"bound {bound:.4f} ms: the inputs read once at 3.35 TB/s (bytes)")
    if timed:
        a_ms = cuda_ms(lambda: select_chunk(dot, den, 0), args.iters)
        print(f"time kernel (a) select_chunk: {a_ms:.4f} ms [{name}]")
    ok, ref = True, None
    for compare in COMPARES:
        got = torch.stack(select_variant(dot, den, 0, compare))
        exact = torch.equal(got, torch.stack(select_variant_reference(dot, den, 0, compare)))
        ok &= exact
        ref = got if ref is None else ref
        line = (f"{compare}: {'kernel' if timed else 'wrapper'} == plain version: {exact}; "
                f"match_i32={torch.equal(got, ref)}")
        if timed:
            ms = cuda_ms(lambda: select_variant(dot, den, 0, compare), args.iters)
            line += f"; {ms:.4f} ms, {bound / ms:.1%} of the bound [{name}]"
        print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
