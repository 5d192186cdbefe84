"""Check and time ``packed_gemm`` (``csrc/packed_gemm.cu``: both int8
products of a packed DB chunk, the DB expanded in the kernel) on one CUDA
card.

The kernel is checked bit for bit against its plain version (the chunk
unpacked, two ``torch._int_mm``) at B = 9, 13, 33 (match rows, 32 a query)
and 13 (spectrum rows, 31 a query) on planted ties, chunks of 304 and 1,000
entries (ragged tiles), and at the scan's B = 128 chunk. Then, at the scan's
chunk shape ([4,096 x 12,800] query rows against 16,384 packed entries),
CUDA-event times in turns: the kernel, the unpack with two
``torch._int_mm`` (the library yardstick), and the unpack with two
``int8_gemm``; with the bound, the card's name and limit, and ptxas's lines
for the kernel.

    python scripts/packed_gemm_probe_torch.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mpc_iris_tpu_torch.benchmarks import HBM_BYTES_PER_S, INT8_OPS, card_line, cuda_ms  # noqa: E402
from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES  # noqa: E402
from mpc_iris_tpu_torch.ops import _build  # noqa: E402
from mpc_iris_tpu_torch.ops import packed_gemm as pg  # noqa: E402
from mpc_iris_tpu_torch.ops.gemm import int8_gemm  # noqa: E402
from mpc_iris_tpu_torch.ops.packed_match import planted_packed_case  # noqa: E402
from mpc_iris_tpu_torch.ops.scan import _fused_rows, prepare_query_planes  # noqa: E402

CHUNK = 16_384
B_SCAN = 128
REPS = 20


def ptxas_lines(log: str) -> list[str]:
    lines = log.splitlines()
    keep = []
    for i, line in enumerate(lines):
        if "packed_gemm_kernel" in line:
            keep += lines[i:i + 4]
        elif "wgmma" in line:
            keep.append(line)
    return keep


def case(dev, b: int, n: int, seed: int):
    """Planted packed DB [n, 1600] x2 and query rows of b queries."""
    pat, msk, qpat, qmsk = planted_packed_case(np.random.default_rng(seed), n=n, b=b)
    q_enc, q_mask = prepare_query_planes(torch.from_numpy(qpat).to(dev),
                                         torch.from_numpy(qmsk).to(dev))
    return (q_enc, q_mask, torch.from_numpy(pat).to(dev), torch.from_numpy(msk).to(dev))


def check(dev) -> bool:
    ok = True
    cases = [("match", 9, 304), ("match", 13, 1000), ("match", 33, 304), ("spectrum", 13, 1000),
             ("match", B_SCAN, CHUNK)]
    for rows, b, n in cases:
        q_enc, q_mask, pat, msk = case(dev, b, n, 1000 * b + n)
        if rows == "match":
            qe, qm = _fused_rows(q_enc), _fused_rows(q_mask)
        else:
            qe, qm = q_enc.reshape(-1, BITS), q_mask.reshape(-1, BITS)
        query = pg.packed_query(qe, qm)
        want = torch.stack(pg.packed_gemm_reference(query, pat, msk))
        got = torch.stack(pg.packed_gemm(query, pat, msk))
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        ok &= same
        print(f"check {rows} B={b} rows={qe.shape[0]} c={n}: "
              f"{'equal' if same else 'DIFFERENT'}"
              + ("" if same else f" ({int((got != want).sum())} values differ)"))
    return ok


def times(dev, card: str) -> None:
    rng = np.random.default_rng(7)
    pat = torch.from_numpy(rng.integers(0, 256, (CHUNK, BITS_BYTES), dtype=np.uint8)).to(dev)
    msk = torch.from_numpy(rng.integers(0, 256, (CHUNK, BITS_BYTES), dtype=np.uint8)).to(dev)
    q_enc, q_mask, _, _ = case(dev, B_SCAN, 512, 11)
    qe, qm = _fused_rows(q_enc), _fused_rows(q_mask)
    query = pg.packed_query(qe, qm)
    m = qe.shape[0]
    ops = 2 * 2 * m * CHUNK * BITS
    n_bytes = 2 * m * BITS + 2 * CHUNK * BITS_BYTES + 2 * 4 * m * CHUNK
    bound_ms = max(ops / INT8_OPS, n_bytes / HBM_BYTES_PER_S) * 1e3

    def library():
        enc, mm = pg._unpack_encode_chunk(pat, msk)
        return torch._int_mm(qe, enc.t()), torch._int_mm(qm, mm.t())

    def gemm():
        enc, mm = pg._unpack_encode_chunk(pat, msk)
        return int8_gemm(qe, enc), int8_gemm(qm, mm)

    runs = {"packed_gemm": lambda: pg.packed_gemm(query, pat, msk),
            "unpack + 2 torch._int_mm": library, "unpack + 2 int8_gemm": gemm}
    got = {k: [] for k in runs}
    for rnd in range(3):
        for name in (list(runs) if rnd % 2 == 0 else list(runs)[::-1]):
            got[name].append(cuda_ms(runs[name], REPS))
    print(f"[{m} x {BITS}] query rows x {CHUNK} packed entries, both products: bound "
          f"{bound_ms:.4f} ms (operations {ops / INT8_OPS * 1e3:.4f}, bytes "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f}) [{card}]")
    for name, ms in got.items():
        best = min(ms)
        print(f"time {name}: {', '.join(f'{x:.4f}' for x in ms)} ms (mean of {REPS}, 3 rounds "
              f"in turns); {bound_ms / best:.1%} of the bound, 31-row share "
              f"{31 / 32 * bound_ms / best:.1%} [{card}]")


def main() -> int:
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    b = _build.build()
    print(f"build {b.seconds:.1f} s")
    for line in ptxas_lines(b.log):
        print("ptxas:", line.strip())
    ok = check(dev)
    print(f"checks: {'all equal' if ok else 'FAILED'}")
    if not ok:
        return 1
    times(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
