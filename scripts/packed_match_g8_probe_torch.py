"""Check and time kernel (b) at B = 8 as one group of eight queries
(``csrc/packed_match_g8.cu``: N = 256 on packed_gemm's warp-specialized
design, the exact selection fused) against the loop it replaces at B = 8,
two groups of 4 in one launch of ``csrc/packed_match.cu``, on one CUDA card.

Both are checked bit for bit: against the plain version
(``match_packed_small_b_reference``) at 64, 700 and 20,001 entries with
planted ties (copies of one entry in both warpgroups of a tile and a walk
step apart, rotation ties, an all-invalid entry, a zero query), and
against each other over every timed DB (also against the plain version over
the first). Then CUDA-event times in turns (group of 8, groups of 4, groups
of 4, group of 8, ...), each call with its query layout, over DBs of
1,048,576 and 6,012,928 random packed entries (one card's share of the
24M-entry sharded cell) made on the card; with the int8 bound, the card's
name and power limit, and ptxas's lines for the new kernel (registers,
spills, barriers).

    python scripts/packed_match_g8_probe_torch.py --out g8_probe.json
    python scripts/packed_match_g8_probe_torch.py --device cpu   # rehearsal: plain versions, no times
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mpc_iris_tpu_torch.benchmarks import INT8_OPS, card_line, cuda_ms  # noqa: E402
from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES  # noqa: E402
from mpc_iris_tpu_torch.models.engines import _pad_chunks  # noqa: E402
from mpc_iris_tpu_torch.ops import _build  # noqa: E402
from mpc_iris_tpu_torch.ops import packed_match as tpm  # noqa: E402
from mpc_iris_tpu_torch.ops.scan import prepare_query_planes  # noqa: E402

B = 8
CHUNK = 16_384  # the engines' chunk
CHECK_N = (64, 700, 20_001)
TIMED_N = (1_048_576, 6_012_928)


def ptxas_lines(log: str) -> list[str]:
    """ptxas's lines for packed_match_kernel_g8: its properties, spills,
    registers and barriers, and any wgmma serialization warning."""
    lines = log.splitlines()
    keep = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "packed_match_kernel_g8" in line:
            keep += lines[i:i + 4]
        elif "wgmma" in line and "packed_match_kernel_g8" in line:
            keep.append(line)
    return [k.strip() for k in keep]


def bound_ms(n: int) -> float:
    """The group's least time over n entries: its int8 operations (31 rows a
    query, two products, 2 ops a MAC) at the int8 peak; the DB's bytes at
    the memory rate take a seventh of it."""
    return 2 * 2 * B * 31 * BITS * n / INT8_OPS * 1e3


def planted(dev, n: int, seed: int):
    """8 prepared queries and a packed DB of n entries in chunks of 304, the
    last padded with all-zero entries (the plain version's products on the
    card take a multiple of 8 entries a chunk): query 0 the self-match of
    entry 129 (or 5 below 700 entries), copied to 193, 257 and, past 10,000
    entries, 129 + 128 x 66 and n - 3; planted_packed_case's rotation ties,
    all-invalid entry and zero query from 700 entries on."""
    rng = np.random.default_rng(seed)
    if n < 700:
        pat = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
        msk = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
        pat[40], msk[40] = pat[5], msk[5]
        qpat, qmsk = pat[rng.integers(0, n, B)].copy(), msk[rng.integers(0, n, B)].copy()
        qpat[0], qmsk[0] = pat[40], msk[40]
    else:
        pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=n, b=B)
        for e in (193, 257) + ((129 + 128 * 66, n - 3) if n > 10_000 else ()):
            pat[e], msk[e] = pat[129], msk[129]
    q_enc, q_mask = prepare_query_planes(torch.from_numpy(qpat).to(dev),
                                         torch.from_numpy(qmsk).to(dev))
    return (q_enc, q_mask, *(torch.from_numpy(_pad_chunks(x, 304)[0]).to(dev) for x in (pat, msk)))


def random_db(dev, n: int, seed: int):
    """8 queries and n random packed entries made on the device, in the
    engine's chunks of 16,384; query 0 copies entry n // 3 (a planted
    winner), query 2 has no valid bit."""
    if n % CHUNK:
        raise ValueError(f"--entries: {n} is not a multiple of {CHUNK}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (n // CHUNK, CHUNK, BITS_BYTES)
    pat = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    msk = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    rows = torch.randint(0, n, (B,), device=dev, generator=gen)
    rows[0] = n // 3
    qpat, qmsk = pat.view(n, BITS_BYTES)[rows], msk.view(n, BITS_BYTES)[rows]
    qmsk[2] = 0
    return (*prepare_query_planes(qpat, qmsk), pat, msk)


def groups_of_4(args) -> torch.Tensor:
    """B = 8 as the loop before the group of 8 took it: one launch of
    csrc/packed_match.cu, two groups of 4."""
    out = torch.empty((3, B), dtype=torch.int32, device=args[0].device)
    n = args[2].shape[0] * args[2].shape[1]
    tpm._launch_int8_group(_build.library(), *args, n, 4, out, B)
    return out


def group_of_8(args) -> torch.Tensor:
    return tpm.match_packed_small_b(*args)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--entries", type=int, nargs="*", default=list(TIMED_N))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device(args.device)
    report = {"checks": [], "times": []}
    if dev.type == "cpu":
        # the plain versions on the CPU: the operand layout and the plan only
        for n in CHECK_N[:2]:
            case = planted(dev, n, n)
            got = tpm.match_packed_small_b(*case)
            assert tpm._launch_plan(B) == [(0, B, tpm.GROUP8)]
            assert tpm._query_tiles(case[0], case[1], tpm.GROUP8).shape == (2 * 32 * B, BITS)
            print(f"rehearsal N={n}: winners {got[2].tolist()}")
        return 0

    card = card_line()
    report["card"] = card
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    b = _build.build()
    report["ptxas"] = ptxas_lines(b.log)
    print(f"build {b.seconds:.1f} s")
    for line in report["ptxas"]:
        print("ptxas:", line)

    ok = True
    for n in CHECK_N:
        case = planted(dev, n, n)
        want = tpm.match_packed_small_b_reference(*case)
        new, old = group_of_8(case), groups_of_4(case)
        torch.cuda.synchronize()
        same = torch.equal(new, want) and torch.equal(old, want)
        ok &= same
        report["checks"].append({"entries": n, "equal": same, "winners": new.tolist()})
        print(f"check N={n}: group of 8 {'==' if torch.equal(new, want) else '!='} plain, "
              f"groups of 4 {'==' if torch.equal(old, want) else '!='} plain; "
              f"query 0 -> {int(new[2, 0])}")

    for i, n in enumerate(args.entries):
        t0 = time.perf_counter()
        case = random_db(dev, n, 1000 + i)
        torch.cuda.synchronize()
        made = time.perf_counter() - t0
        new, old = group_of_8(case), groups_of_4(case)
        same = torch.equal(new, old)
        if i == 0:
            same &= torch.equal(new, tpm.match_packed_small_b_reference(*case))
        ok &= same
        times = {"group of 8": [], "groups of 4": []}
        for rnd in range(args.rounds):
            order = ("group of 8", "groups of 4") if rnd % 2 == 0 else ("groups of 4", "group of 8")
            for name in order:
                fn = group_of_8 if name == "group of 8" else groups_of_4
                times[name].append(cuda_ms(lambda: fn(case), args.reps))
        bnd = bound_ms(n)
        row = {"entries": n, "bound_ms": bnd, "equal": same, "db_made_s": made,
               "ms": times, "card": card}
        report["times"].append(row)
        print(f"N={n} B={B}: results {'equal' if same else 'DIFFERENT'}; bound {bnd:.4f} ms "
              f"(int8 operations) [{card}]")
        for name, ms in times.items():
            best = min(ms)
            print(f"  {name}: {', '.join(f'{x:.4f}' for x in ms)} ms (mean of {args.reps}, "
                  f"{args.rounds} rounds in turns); {bnd / best:.1%} of the bound")
        del case
        torch.cuda.empty_cache()

    report["ok"] = ok
    print(f"checks: {'all equal' if ok else 'FAILED'}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
