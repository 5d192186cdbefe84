"""The select bisect on an NVIDIA GPU: the PyTorch + CUDA counterpart of
scripts/select_bisect.py, kernel (a) cut off stage by stage.

Each mode is ``bisect`` (csrc/stream_probes.cu) at the probe's two tile
shapes, (8, 2,048) and (4, 8,192): ``dma`` (the stream, dot + den at the
block's first rows), ``reshape`` (one row's numerator), ``rot`` (the
rotation tree at the first column), ``col`` (the column tree over one row),
``full`` (both: s1's ``i32`` select). Every column tile overwrites the
outputs, so each mode returns the last tile's values, though every tile is
read and worked as in the probe. Inputs as the probe's: b = 128 queries of
32 rows over n = 32,768 columns, dot in [-12,800, 12,800], den in [0,
12,800], made on the device from ``--seed``. Per variant: the kernel
against its plain version on the same device (bit for bit), its CUDA-event
time, rate and bound (the inputs read once at 3.35 TB/s, 0.3205 ms), beside
kernel (a) ``select_chunk`` and s1's ``select_variant("i32")`` on the same
inputs, with the card's name and power limit. ``--device cpu`` rehearses at
a small size (``--b 8 --n 16384``) and prints no times.

    python scripts/select_bisect_torch.py
    python scripts/select_bisect_torch.py --device cpu --b 8 --n 16384
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
from mpc_iris_tpu_torch.smoke_data import BISECT_RANGES, stream_inputs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--b", type=int, default=128, help="queries (a multiple of 8)")
    ap.add_argument("--n", type=int, default=32_768, help="columns (a multiple of 8,192)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if args.b <= 0 or args.b % 8 or args.n <= 0 or args.n % 8192:
        ap.error(f"the probe's tiles (8 queries, 8,192 columns at most) must divide "
                 f"--b {args.b} and --n {args.n}")
    dev = torch.device(args.device)
    timed = dev.type == "cuda"
    if timed and not torch.cuda.is_available():
        print("select_bisect_torch: no CUDA card available", file=sys.stderr)
        return 1
    card = card_line() if timed else None
    dot, den = stream_inputs(args.b * 32, args.n, args.seed, dev, BISECT_RANGES)
    print(f"inputs int32 [{args.b * 32}, {args.n}] x2 on {dev} [{card or 'cpu (no times)'}]")
    if timed:
        a_ms = cuda_ms(lambda: select_chunk(dot, den, 0), args.iters)
        s1_ms = cuda_ms(lambda: select_variant(dot, den, 0, "i32"), args.iters)
        print(f"time kernel (a) select_chunk {a_ms:.4f} ms, select_variant i32 {s1_ms:.4f} ms "
              f"on the same inputs [{card}]")
    ok = check_variants(main_variants("bisect", dot, den), lambda _: 8 * dot.numel(), card,
                        args.iters)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
