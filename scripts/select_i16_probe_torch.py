"""Does an int16-carrying select tree beat the int32 tree? The PyTorch + CUDA
counterpart of scripts/select_i16_probe.py, on an NVIDIA GPU.

Both trees are ``select_lanes`` (csrc/select_probes.cu): int16 dot and den
[B*32, N] (B = 256, N = 32,768: 1.07 GB), the probe's keep-first rotation
tree, the column tree of each 2,048-column tile down to 128 lanes and the
fold over tiles, per query the 128 lane winners [B, 384]; the int16 tree
carries n = (den - dot) >> 1 and d in int16. The inputs are the probe's
(den, num uniform in [0, 12,800], dot = den - 2 num), made on the device from
``--seed``. Prints each tree's kernel against its plain version on the same
device (bit for bit), whether the trees agree (as the probe prints), the
CUDA-event times and the bound (the bytes read once at 3.35 TB/s), with the
card's name and power limit. ``--device cpu`` rehearses at a small size and
prints no times.

    python scripts/select_i16_probe_torch.py
    python scripts/select_i16_probe_torch.py --device cpu --b 8 --n 4096
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
from mpc_iris_tpu_torch.ops.select_probes import (  # noqa: E402
    select_lanes,
    select_lanes_reference,
)
from mpc_iris_tpu_torch.smoke_data import probe_inputs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--b", type=int, default=256, help="queries (a multiple of 8)")
    ap.add_argument("--n", type=int, default=32_768, help="columns (a multiple of 2,048)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device(args.device)
    timed = dev.type == "cuda"
    if timed and not torch.cuda.is_available():
        print("select_i16_probe_torch: no CUDA card available", file=sys.stderr)
        return 1
    name = card_line() if timed else "cpu (no times)"
    dot, den = probe_inputs(args.b, args.n, args.seed, dev, torch.int16)
    bound = 2 * dot.numel() * 2 / HBM_BYTES_PER_S * 1e3
    print(f"inputs int16 [{args.b * 32}, {args.n}] x2 on {dev} [{name}]")
    if timed:
        print(f"bound {bound:.4f} ms: the inputs read once at 3.35 TB/s (bytes)")
    outs, ok = {}, True
    for tree, i16 in (("int32", False), ("int16", True)):
        outs[tree] = select_lanes(dot, den, i16)
        exact = torch.equal(outs[tree], select_lanes_reference(dot, den, i16))
        ok &= exact
        line = f"{tree} tree: {'kernel' if timed else 'wrapper'} == plain version: {exact}"
        if timed:
            ms = cuda_ms(lambda: select_lanes(dot, den, i16), args.iters)
            line += f"; {ms:.4f} ms, {bound / ms:.1%} of the bound [{name}]"
        print(line, flush=True)
    print("i16 == i32 results:", torch.equal(outs["int16"], outs["int32"]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
