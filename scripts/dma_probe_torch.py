"""The streaming probe on an NVIDIA GPU: the PyTorch + CUDA counterpart of
scripts/dma_probe.py.

Each variant of the probe's main is ``dma_variant`` (csrc/stream_probes.cu):
per (tb, tn) block of int32 dot and den [B, N] the (8, 128) corner, every
byte of the block streamed through shared memory as the TPU's BlockSpec
copies it. The nine variants: two inputs, one input, revisit (the corners
summed over the column blocks), the probe's prefetch and dimension-semantics
variants (which change no value: they run as the plain two-input variant),
and tiles (512, 4,096) and (1,024, 2,048). Inputs as the probe's: B = 4,096,
N = 32,768, dot in [-100, 100), den in [0, 100), made on the device from
``--seed``. Per variant: the kernel against its plain version on the same
device (bit for bit), its CUDA-event time, rate and bound (the inputs read
once at 3.35 TB/s: 0.3205 ms for two, 0.160 for one), beside kernel (a)
``select_chunk`` and s1's ``select_variant("i32")`` on the same inputs, with
the card's name and power limit. ``--device cpu`` rehearses at a small size
(``--b 1024 --n 4096``) and prints no times.

    python scripts/dma_probe_torch.py
    python scripts/dma_probe_torch.py --device cpu --b 1024 --n 4096
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mpc_iris_tpu_torch.benchmarks import card_line, check_variants, cuda_ms  # noqa: E402
from mpc_iris_tpu_torch.ops.select import select_chunk  # noqa: E402
from mpc_iris_tpu_torch.ops.select_probes import select_variant  # noqa: E402
from mpc_iris_tpu_torch.ops.stream_probes import main_variants  # noqa: E402
from mpc_iris_tpu_torch.smoke_data import stream_inputs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--b", type=int, default=4096, help="rows (a multiple of 1,024)")
    ap.add_argument("--n", type=int, default=32_768, help="columns (a multiple of 4,096)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if args.b <= 0 or args.b % 1024 or args.n <= 0 or args.n % 4096:
        ap.error(f"the variants' tiles (up to 1,024 rows and 4,096 columns) must divide "
                 f"--b {args.b} and --n {args.n}")
    dev = torch.device(args.device)
    timed = dev.type == "cuda"
    if timed and not torch.cuda.is_available():
        print("dma_probe_torch: no CUDA card available", file=sys.stderr)
        return 1
    card = card_line() if timed else None
    dot, den = stream_inputs(args.b, args.n, args.seed, dev)
    print(f"inputs int32 [{args.b}, {args.n}] x2 on {dev} [{card or 'cpu (no times)'}]")
    if timed:
        a_ms = cuda_ms(lambda: select_chunk(dot, den, 0), args.iters)
        s1_ms = cuda_ms(lambda: select_variant(dot, den, 0, "i32"), args.iters)
        print(f"time kernel (a) select_chunk {a_ms:.4f} ms, select_variant i32 {s1_ms:.4f} ms "
              f"on the same inputs [{card}]")
    ok = check_variants(main_variants("dma_variant", dot, den),
                        lambda label: (1 if label.startswith("1in") else 2) * 4 * dot.numel(),
                        card, args.iters)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
