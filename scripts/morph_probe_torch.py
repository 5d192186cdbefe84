"""The morph probes on an NVIDIA GPU: the PyTorch + CUDA counterpart of
scripts/morph_probe.py, from the bare stream to kernel (a)'s selection.

``--part main``: ``morph_stage`` 0-5 (the corner summed over the column
blocks into 1 or 3 outputs, with or without scratch; the 32-row sum; the
rotation tree; both trees to 128 lanes, folded keep-first); ``main2``:
``morph2``'s five variants (tile 0's corners, their sum, the trees folded,
128 or 384 lanes; the probe's prefetch variant runs as "=select"); ``main3``:
kernel (a) ``select_chunk``, then ``morph3`` without and with the index-aware
lane tree; ``all`` (the default): the three. Every kernel is
csrc/stream_probes.cu. Inputs as the probe's: B = 4,096, N = 32,768 int32,
dot in [-100, 100), den in [0, 100), made on the device from ``--seed``.
Per variant: the kernel against its plain version on the same device (bit
for bit), its CUDA-event time, rate and bound (the inputs read once at
3.35 TB/s, 0.3205 ms), beside (a) and s1's ``select_variant("i32")`` on the
same inputs, with the card's name and power limit. ``--device cpu``
rehearses at a small size (``--b 512 --n 4096``) and prints no times.

    python scripts/morph_probe_torch.py [--part main|main2|main3|all]
    python scripts/morph_probe_torch.py --device cpu --b 512 --n 4096
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

PARTS = {"main": "morph_stage", "main2": "morph2", "main3": "morph3"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--part", choices=[*PARTS, "all"], default="all")
    ap.add_argument("--b", type=int, default=4096, help="rows (a multiple of 256)")
    ap.add_argument("--n", type=int, default=32_768, help="columns (a multiple of 2,048)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if args.b <= 0 or args.b % 256 or args.n <= 0 or args.n % 2048:
        ap.error(f"the probe's blocks (256 rows, 2,048 columns) must divide --b {args.b} "
                 f"and --n {args.n}")
    dev = torch.device(args.device)
    timed = dev.type == "cuda"
    if timed and not torch.cuda.is_available():
        print("morph_probe_torch: no CUDA card available", file=sys.stderr)
        return 1
    card = card_line() if timed else None
    dot, den = stream_inputs(args.b, args.n, args.seed, dev)
    print(f"inputs int32 [{args.b}, {args.n}] x2 on {dev} [{card or 'cpu (no times)'}]")
    if timed:
        a_ms = cuda_ms(lambda: select_chunk(dot, den, 0), args.iters)
        s1_ms = cuda_ms(lambda: select_variant(dot, den, 0, "i32"), args.iters)
        print(f"time kernel (a) select_chunk {a_ms:.4f} ms, select_variant i32 {s1_ms:.4f} ms "
              f"on the same inputs [{card}]")
    ok = True
    for part, probe in PARTS.items():
        if args.part in (part, "all"):
            print(f"-- {part}: {probe}", flush=True)
            ok &= check_variants(main_variants(probe, dot, den), lambda _: 8 * dot.numel(),
                                 card, args.iters)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
