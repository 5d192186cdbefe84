"""The designs of the B = 1 pk-dot kernel against each other on one card,
each output bit-checked, and the issue rate of the binary tensor
instruction the shipped design runs on.

- The package's ``pk_dot`` (csrc/b1_packed.cu, binary: four AND-popcount
  products of packed bits on ``mma.sync`` b1, no unpack) and the int8
  design of ``scripts/b1_packed_variants.cu`` (DB entries on wgmma's N side
  at N = 256, both products in one accumulator) at 512 and 256 entries a
  block, each with and without a 2-block cluster multicasting the query
  copies. That source is compiled here (nvcc, the flags of
  ``ops/_build.py``) into a library of its own under
  ``mpc_iris_tpu_torch/build/``; the package does not build it. Over
  ``--db`` packed entries at B = 1 made on the card from the seed (entry 0
  all masked, the last all set). Timed by CUDA events in turns (a, b, ..., b, a; each
  design's median of its two turns); every output equals
  ``pk_dot_reference`` bit for bit. Beside each: the function's bound (the
  packed DB read once and the output written once, at 3.35 TB/s) and the
  design's floor (int8: its 64 x 25,600 x 2 operations an entry at 1,979
  TOPS; binary: the function's bound, its products being shorter at the
  rate measured here).
- The b1 rate: ``mma.sync.m16n8k256.b1.b1.s32.and.popc`` on register
  operands, 8 independent accumulators a warp, 8 warps a block, 4 blocks an
  SM; its instructions a second and a SM clock, and the time of the 50 such
  instructions an entry (4 AND-popcount products of 12,800 bits, 32
  positions) at ``--db`` entries. The accumulators of every warp equal a
  numpy model of the fragment layout (a lane's a0 / a2 and b0 / b1 cover
  the K words t and 4 + t).
- From the builds: ptxas's registers and spills of each pk_dot kernel (the
  package's where this process built its library), and the tensor
  instructions (``IGMMA``, ``BMMA``) in each one's SASS.

Prints the card's name, power limit and SM clock. Needs a CUDA card.

    python scripts/b1_packed_variants_torch.py [--db 1048576] [--out build/b1_variants.json]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "scripts")):
    if path not in sys.path:
        sys.path.insert(0, path)

from mpc_iris_tpu_torch.benchmarks import HBM_BYTES_PER_S, INT8_OPS  # noqa: E402
from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES  # noqa: E402
from mpc_iris_tpu_torch.ops import _build  # noqa: E402
from mpc_iris_tpu_torch.ops.b1_packed import PLANE, pk_dot, pk_dot_reference  # noqa: E402
from probe_kernels_old_vs_new_torch import (  # noqa: E402
    card_line,
    cuda_ms,
    pk_inputs,
    sass_functions,
)

SOURCE = os.path.join(REPO, "scripts", "b1_packed_variants.cu")
REPS = 10
# the int8 design's variants, in pk_dot_int8_launch's order
INT8_VARIANTS = ("int8-512", "int8-512-multicast", "int8-256", "int8-256-multicast")
RATE_BLOCKS_PER_SM, RATE_THREADS, RATE_ITERS, RATE_CHAINS = 4, 256, 2048, 8
B1_PER_ENTRY = 50  # (64 rows / 16) x (2 columns / 8) x (12,800 bits / 256) mma.sync an entry


def dot_den_rows(qe: torch.Tensor, qm: torch.Tensor):
    """(qe, qm) int8 [32, 12,800] -> (A1, A2) int8 [64, 12,800], the int8
    design's query rows: for position p = 8w + g, row 16w + g is qe(p) in both
    and row 16w + 8 + g is qm(p) in A1 and zero in A2. Against the DB's mask
    bits (A1) and its pattern-and-mask bits times -2 (A2), the qe(p) row sums
    dot = qe . (m - 2 (p & m)) and the qm(p) row den = qm . m; wgmma's
    accumulator gives both rows of a position to one thread."""
    qe4, qm4 = qe.view(4, 8, BITS), qm.view(4, 8, BITS)
    a1 = torch.stack([qe4, qm4], dim=1).reshape(64, BITS)
    a2 = torch.stack([qe4, torch.zeros_like(qm4)], dim=1).reshape(64, BITS)
    return a1, a2


def int8_operand(qe: torch.Tensor, qm: torch.Tensor) -> torch.Tensor:
    """(qe, qm) -> int8 [50, 8, 2, 8, 2, 8, 16], the int8 design's query
    operand: per K-step s = jj * 8 + b (bit-plane b of the 32-byte slab jj,
    K = b * 1600 + jj * 32 + 0..31), 4 KB: A1 then A2 of :func:`dot_den_rows`,
    each 64 rows x 32 bytes in the order wgmma reads them from shared memory
    (8-row groups, the two 16-byte K halves, 8 rows, 16 bytes)."""
    a = torch.stack(dot_den_rows(qe, qm)).reshape(2, 8, 8, 8, PLANE // 32, 2, 16)
    return a.permute(4, 3, 0, 1, 5, 2, 6).contiguous()  # jj, b, A, row group, half, row, byte


def build_variants() -> tuple[ctypes.CDLL, str, str]:
    """scripts/b1_packed_variants.cu compiled (or reused: keyed by a hash of
    it, the headers and the flags) into its own library; returns the library,
    its path and ptxas's log of the build that made it."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for path in (SOURCE, *sorted(map(str, _build.CSRC.glob("*.cuh")))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    out = _build.BUILD_DIR / f"libb1_packed_variants_{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                               str(_build.CSRC), "-o", str(tmp), SOURCE],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pk_dot_int8_launch.argtypes = [i, p, p, p, ll, p, p]
    lib.b1_mma_rate_launch.argtypes = [i, i, i, p, p, p]
    lib.pk_dot_int8_launch.restype = lib.b1_mma_rate_launch.restype = i
    return lib, str(out), log_path.read_text() if log_path.exists() else ""


def int8_pk_dot(lib, variant: str, qe, qm, pat, msk):
    """A call of the int8 design as pk_dot's wrapper would make it: the
    operand laid out, one launch."""
    def run():
        a = int8_operand(qe, qm)
        out = torch.empty((32, pat.shape[0]), dtype=torch.int32, device=qe.device)
        _build.check_launch(variant, lib.pk_dot_int8_launch(
            INT8_VARIANTS.index(variant), a.data_ptr(), pat.data_ptr(), msk.data_ptr(),
            pat.shape[0], out.data_ptr(), torch.cuda.current_stream().cuda_stream))
        return out
    return run


def pk_dot_bounds(n: int) -> dict:
    """The function's bound and each design's floor, ms at n entries."""
    n_bytes = 2 * BITS_BYTES * n + 2 * 32 * BITS + 4 * 32 * n
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound": bound, "b1": bound, "int8": n * 64 * 2 * BITS * 2 / INT8_OPS * 1e3}


def designs_in_turns(lib, args_, n: int, card: str) -> dict:
    want = pk_dot_reference(*args_)
    runs = {"b1": lambda: pk_dot(*args_),
            **{v: int8_pk_dot(lib, v, *args_) for v in INT8_VARIANTS}}
    equal = {d: torch.equal(run(), want) for d, run in runs.items()}
    del want
    times = {d: [] for d in runs}
    for d in [*runs, *reversed(runs)]:
        times[d].append(cuda_ms(runs[d], REPS))
    bounds = pk_dot_bounds(n)
    res = {}
    for d in runs:
        ms = float(np.median(times[d]))
        floor = bounds[d.split("-")[0]]
        res[d] = {"ms": ms, "turns": times[d], "equal": equal[d],
                  "bound_share": bounds["bound"] / ms, "floor_ms": floor, "floor_share": floor / ms}
        print(f"pk_dot design {d} N={n}: {ms:.4f} ms (turns {times[d][0]:.4f}, "
              f"{times[d][1]:.4f}); {bounds['bound'] / ms:.1%} of the function's bound "
              f"{bounds['bound']:.4f} ms, {floor / ms:.1%} of the design's floor {floor:.4f} ms; "
              f"bit-equal to pk_dot_reference {equal[d]} [{card}]", flush=True)
    return res


def b1_model(frags: np.ndarray) -> np.ndarray:
    """One mma.sync m16n8k256 b1 AND+popc on the fragments [32 lanes][a0..a3,
    b0, b1]: int64 [32][4], lane 4g + t holding D rows (g, g + 8) x columns
    (2t, 2t + 1). A lane's a0 (row g), a1 (row g + 8) and b0 (column g)
    cover the K word t, a2, a3 and b1 the K word 4 + t."""
    a_words = np.zeros((16, 8), dtype=np.uint32)
    b_words = np.zeros((8, 8), dtype=np.uint32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        a_words[g, t], a_words[g + 8, t] = frags[lane, 0], frags[lane, 1]
        a_words[g, 4 + t], a_words[g + 8, 4 + t] = frags[lane, 2], frags[lane, 3]
        b_words[t, g], b_words[4 + t, g] = frags[lane, 4], frags[lane, 5]
    d = np.zeros((16, 8), dtype=np.int64)
    for r in range(16):
        for c in range(8):
            d[r, c] = sum(bin(int(a_words[r, k] & b_words[k, c])).count("1") for k in range(8))
    out = np.zeros((32, 4), dtype=np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        out[lane] = [d[g, 2 * t], d[g, 2 * t + 1], d[g + 8, 2 * t], d[g + 8, 2 * t + 1]]
    return out


def b1_rate(lib, dev: torch.device, n: int, card: str, sm_mhz: float) -> dict:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = RATE_BLOCKS_PER_SM * sms
    warps = blocks * RATE_THREADS // 32
    frags = np.random.default_rng(7).integers(0, 2**32, (32, 6), dtype=np.uint64).astype(np.uint32)
    frags_t = torch.from_numpy(frags.view(np.int32)).to(dev)
    out = torch.empty((warps, 32, 4), dtype=torch.int32, device=dev)

    def run():
        _build.check_launch("b1_mma_rate", lib.b1_mma_rate_launch(
            blocks, RATE_THREADS, RATE_ITERS, frags_t.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream))

    ms = cuda_ms(run, 3)
    want = torch.from_numpy(b1_model(frags) * RATE_ITERS * RATE_CHAINS).to(dev)
    equal = bool((out.long() == want).all())
    count = warps * RATE_ITERS * RATE_CHAINS
    per_s = count / ms * 1e3
    clocks = sms * sm_mhz * 1e6 / per_s  # SM clocks an instruction, each SM
    products_ms = B1_PER_ENTRY * n / per_s * 1e3
    print(f"b1 mma.sync m16n8k256 AND+popc: {count} in {ms:.4f} ms, {per_s:.4e} a second, "
          f"{clocks:.2f} SM clocks each an SM at {sm_mhz:.0f} MHz ({2 * 16 * 8 * 256 * per_s:.4e} "
          f"bit operations a second); a binary pk_dot's {B1_PER_ENTRY * n} products at N={n}: "
          f"{products_ms:.4f} ms; accumulators equal the fragment model: {equal} [{card}]",
          flush=True)
    return {"ms": ms, "instructions": count, "per_s": per_s, "sm_clocks_each": clocks,
            "products_ms": products_ms, "equal": equal}


def build_report(variants_path: str, variants_log: str) -> dict:
    """ptxas's lines and the SASS tensor instructions of each pk_dot kernel
    (the package's and the variants')."""
    b = _build.build()
    ptxas, cur = {}, None
    for line in (b.log + variants_log).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if "pk_dot" in m.group(1) else None
        elif cur and ("registers" in line or "spill" in line):
            ptxas.setdefault(cur, []).append(line.split("info    : ")[-1].strip())
    sass = {name: {op: sum(o.startswith(op) for o in ops) for op in ("IGMMA", "BMMA")}
            for path in (str(b.path), variants_path)
            for name, ops in sass_functions(path).items() if "pk_dot" in name}
    for name in sorted(set(ptxas) | set(sass)):
        print(f"build {name}: ptxas {ptxas.get(name, ['(library reused: no log)'])}; "
              f"tensor instructions in the SASS: {sass.get(name)}")
    return {"ptxas": ptxas, "sass": sass}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--db", type=int, default=1_048_576)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b1_packed_variants_torch: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    sm_mhz = float(card.split(",")[-1].strip().split()[0])
    lib, lib_path, lib_log = build_variants()
    res = {"card": card, "script": "scripts/b1_packed_variants_torch.py", "db": args.db,
           "build": build_report(lib_path, lib_log)}
    res["designs"] = designs_in_turns(lib, pk_inputs(args.db, args.seed, dev), args.db, card)
    res["b1_rate"] = b1_rate(lib, dev, args.db, card, sm_mhz)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    ok = all(r["equal"] for r in res["designs"].values()) and res["b1_rate"]["equal"]
    print(f"every output bit-equal: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
