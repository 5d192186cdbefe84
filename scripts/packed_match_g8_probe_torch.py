"""Check and time kernels (b) and (c) at B = 8 as one group of eight queries
(``csrc/packed_match_g8.cu``: N = 256 on packed_gemm's warp-specialized
design, one tile loop, the match's exact selection or the spectrum's
per-entry rotation minimum fused) against the loops they replace at B = 8,
two groups of 4 in one launch of ``csrc/packed_match.cu`` or
``csrc/packed_fractions.cu``, on one CUDA card.

Every output is checked bit for bit: against the plain versions
(``match_packed_small_b_reference``, ``fractions_packed_small_b_reference``)
at 64, 700 and 20,001 entries with planted ties (copies of one entry in both
warpgroups of a tile and a walk step apart, rotation ties, an all-invalid
entry, a zero query), and against each other over every timed DB (also
against the plain version over the first). Then CUDA-event times in turns
(group of 8, groups of 4, groups of 4, group of 8, ...), each call with its
query layout: the match over DBs of 1,048,576 and 6,012,928 random packed
entries (one card's share of the 24M-entry sharded cell), the spectrum over
1,048,576 and 3,014,656 (the 3M-entry DB in the engine's chunks), made on
the card; with the int8 bound, the card's name and power limit, and
ptxas's lines for both kernels (registers, spills, barriers).

With ``--old DIR`` (an earlier commit's ``mpc_iris_tpu_torch/csrc``,
unpacked beforehand), its ``packed_match_g8.cu`` is built alone into its own
library and the match's group of 8, launched bare
(``match_packed_g8_launch`` on one prepared operand), is timed in turns
against the package's over the match's DBs (old, new, new, old, ...), the
two bit-equal, with the old build's ptxas lines:

    git archive <commit> mpc_iris_tpu_torch/csrc | tar -x -C build/parent
    python scripts/packed_match_g8_probe_torch.py --out g8_probe.json \\
        --old build/parent/mpc_iris_tpu_torch/csrc
    python scripts/packed_match_g8_probe_torch.py --device cpu   # rehearsal: plain versions, no times
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
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
SPECTRUM_N = (1_048_576, 3_014_656)
KERNELS = ("packed_match_kernel_g8", "packed_fractions_kernel_g8")


def ptxas_lines(log: str) -> list[str]:
    """ptxas's lines for the group of 8's kernels: their properties, spills,
    registers and barriers, and any wgmma serialization warning."""
    lines = log.splitlines()
    keep = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(k in line for k in KERNELS):
            keep += lines[i:i + 4]
        elif "wgmma" in line and any(k in line for k in KERNELS):
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


def n_entries(args) -> int:
    return args[2].shape[0] * args[2].shape[1]


def groups_of_4(args) -> torch.Tensor:
    """B = 8's match as the loop before the group of 8 took it: one launch of
    csrc/packed_match.cu, two groups of 4."""
    out = torch.empty((3, B), dtype=torch.int32, device=args[0].device)
    tpm._launch_int8_group(_build.library(), *args, n_entries(args), 4, out, B)
    return out


def group_of_8(args) -> torch.Tensor:
    return tpm.match_packed_small_b(*args)


def spectrum_groups_of_4(args) -> torch.Tensor:
    """B = 8's spectrum as the loop before the group of 8 took it: one
    launch of csrc/packed_fractions.cu, two groups of 4."""
    n = n_entries(args)
    out = torch.empty((2, B, n), dtype=torch.int16, device=args[0].device)
    tpm._launch_int8_fractions(_build.library(), *args, n, 4, out[0, 0], B * n)
    return out


def spectrum_group_of_8(args) -> torch.Tensor:
    return tpm.fractions_packed_small_b(*args)


def build_old(csrc: str):
    """The old tree's packed_match_g8.cu alone, built by nvcc (the package's
    flags) into its own library; returns it and nvcc's output."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in sorted(os.listdir(csrc)):
        h.update(f.encode())
        with open(os.path.join(csrc, f), "rb") as fh:
            h.update(fh.read())
    out = _build.BUILD_DIR / f"libold_g8_{h.hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                          os.path.join(csrc, "packed_match_g8.cu")],
                         capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(out))
    for name in ("match_packed_g8_scratch", "match_packed_g8_launch"):
        fn, (argtypes, restype) = getattr(lib, name), _build._SIGNATURES[name]
        fn.argtypes, fn.restype = argtypes, restype
    return lib, run.stdout + run.stderr


def bare_match(lib, args, qt: torch.Tensor):
    """The match's group of 8 from ``lib``, launched bare on the prepared
    operand ``qt`` (its fold included); returns the call and its output."""
    n = n_entries(args)
    scratch = torch.empty(lib.match_packed_g8_scratch(n), dtype=torch.int32,
                          device=qt.device)
    out = torch.empty((3, B), dtype=torch.int32, device=qt.device)

    def run():
        _build.check_launch("match_packed_g8_launch", lib.match_packed_g8_launch(
            qt.data_ptr(), args[2].data_ptr(), args[3].data_ptr(), n, scratch.data_ptr(),
            out.data_ptr(), B, torch.cuda.current_stream().cuda_stream))
        return out
    return run


def in_turns(calls: dict, rounds: int, reps: int) -> dict:
    """Each call's CUDA-event times, ``rounds`` rounds in turns: the first
    call first in even rounds, last in odd ones."""
    names = list(calls)
    times = {name: [] for name in names}
    for rnd in range(rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            times[name].append(cuda_ms(calls[name], reps))
    return times


def report_times(kind: str, n: int, times: dict, reps: int, rounds: int, card: str) -> None:
    bnd = bound_ms(n)
    print(f"{kind} N={n} B={B}: bound {bnd:.4f} ms (int8 operations) [{card}]")
    for name, ms in times.items():
        print(f"  {name}: {', '.join(f'{x:.4f}' for x in ms)} ms (mean of {reps}, {rounds} "
              f"rounds in turns); {bnd / min(ms):.1%} of the bound")


def rehearse(dev) -> int:
    """The plain versions on the CPU: the operand layout, the plan and the
    planted cases' winners and self-match pairs."""
    for n in CHECK_N[:2]:
        case = planted(dev, n, n)
        got = tpm.match_packed_small_b(*case)
        nd = tpm.fractions_packed_small_b(*case)
        assert tpm._launch_plan(B) == [(0, B, tpm.GROUP8)]
        assert tpm._query_tiles(case[0], case[1], tpm.GROUP8).shape == (2 * 32 * B, BITS)
        e = int(got[2, 0])
        print(f"rehearsal N={n}: winners {got[2].tolist()}; spectrum of query 0 at {e}: "
              f"({int(nd[0, 0, e])}, {int(nd[1, 0, e])})")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--entries", type=int, nargs="*", default=list(TIMED_N))
    ap.add_argument("--spectrum-entries", type=int, nargs="*", default=list(SPECTRUM_N))
    ap.add_argument("--old", default=None, help="an earlier commit's mpc_iris_tpu_torch/csrc")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cpu":
        return rehearse(dev)
    report = {"checks": [], "times": [], "spectrum_times": [], "old_vs_new": []}

    card = card_line()
    report["card"] = card
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    b = _build.build()
    report["ptxas"] = ptxas_lines(b.log)
    print(f"build {b.seconds:.1f} s")
    for line in report["ptxas"]:
        print("ptxas:", line)
    old = None
    if args.old:
        old, log = build_old(args.old)
        report["old_ptxas"] = ptxas_lines(log)
        for line in report["old_ptxas"]:
            print("old ptxas:", line)

    ok = True
    for n in CHECK_N:
        case = planted(dev, n, n)
        row = {"entries": n}
        for kind, new_fn, old_fn, plain in (
                ("match", group_of_8, groups_of_4, tpm.match_packed_small_b_reference),
                ("spectrum", spectrum_group_of_8, spectrum_groups_of_4,
                 tpm.fractions_packed_small_b_reference)):
            want = plain(*case)
            new, four = new_fn(case), old_fn(case)
            torch.cuda.synchronize()
            same = torch.equal(new, want) and torch.equal(four, want)
            ok &= same
            row[kind] = same
            print(f"check {kind} N={n}: group of 8 {'==' if torch.equal(new, want) else '!='} "
                  f"plain, groups of 4 {'==' if torch.equal(four, want) else '!='} plain")
        report["checks"].append(row)

    for i, n in enumerate(args.entries):
        t0 = time.perf_counter()
        case = random_db(dev, n, 1000 + i)
        torch.cuda.synchronize()
        made = time.perf_counter() - t0
        new, four = group_of_8(case), groups_of_4(case)
        same = torch.equal(new, four)
        if i == 0:
            same &= torch.equal(new, tpm.match_packed_small_b_reference(*case))
        calls = {"group of 8": lambda: group_of_8(case), "groups of 4": lambda: groups_of_4(case)}
        times = in_turns(calls, args.rounds, args.reps)
        report["times"].append({"entries": n, "bound_ms": bound_ms(n), "equal": same,
                                "db_made_s": made, "ms": times, "card": card})
        print(f"match results {'equal' if same else 'DIFFERENT'}")
        report_times("match", n, times, args.reps, args.rounds, card)
        if old is not None:
            qt = tpm._query_tiles(case[0], case[1], tpm.GROUP8)
            calls = {"parent": bare_match(old, case, qt),
                     "change": bare_match(_build.library(), case, qt)}
            same_old = torch.equal(calls["parent"](), calls["change"]())
            same &= same_old
            times = in_turns(calls, 2 * args.rounds, args.reps)
            report["old_vs_new"].append({"entries": n, "equal": same_old, "ms": times,
                                         "card": card})
            print(f"match group of 8, parent's build against the change's: results "
                  f"{'equal' if same_old else 'DIFFERENT'}")
            report_times("match (bare launch)", n, times, args.reps, 2 * args.rounds, card)
        ok &= same
        del case, calls
        torch.cuda.empty_cache()

    for i, n in enumerate(args.spectrum_entries):
        case = random_db(dev, n, 2000 + i)
        new, four = spectrum_group_of_8(case), spectrum_groups_of_4(case)
        same = torch.equal(new, four)
        if i == 0:
            same &= torch.equal(new, tpm.fractions_packed_small_b_reference(*case))
        ok &= same
        del new, four
        calls = {"group of 8": lambda: spectrum_group_of_8(case),
                 "groups of 4": lambda: spectrum_groups_of_4(case)}
        times = in_turns(calls, args.rounds, args.reps)
        report["spectrum_times"].append({"entries": n, "bound_ms": bound_ms(n), "equal": same,
                                         "ms": times, "card": card})
        print(f"spectrum results {'equal' if same else 'DIFFERENT'}")
        report_times("spectrum", n, times, args.reps, args.rounds, card)
        del case, calls
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
