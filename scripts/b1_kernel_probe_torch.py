"""B = 1 packed-dot probe on an NVIDIA GPU: the PyTorch + CUDA counterpart of
scripts/b1_kernel_probe.py (the TPU's in-VMEM unpack + slab dots, and the
selection fused in too, for the single-query serving shape).

Variants, each one kernel launch over the packed DB [N, 1600] with the
query of ``prep_query`` (rows bit-reversed, K bit-plane-major):

  pk-dot     ``pk_dot`` (csrc/b1_packed.cu): int32 [32, N] = (den << 16) |
             num, then the plain epilogue ``pk_dot_winner`` selects (ties to
             the lowest row POSITION, as the probe's epilogue)
  pk-select  ``pk_select`` (csrc/b1_packed.cu, pk_dot's tile loop): the
             selection fused in, one [3, 1] winner; the probe's kernel is
             kernel (b) at B = 1, and match_packed_small_b launches the same
             kernel for a group of one query

``--check`` holds both on the CPU against the port's unfused packed scan
(``_match_scan_packed(fused=False)``) at 4,096 entries with a planted
self-match. On the card (the default) the DB is made on the card from the
seed; each variant's winner is held against the unfused scan and kernel
(b)'s int8 design at one query (``match_packed_int8_pairs``: a group of 2
with a zero query; pk-dot by index and exact fraction, since its pair may
differ on rotation ties), then timed by CUDA events beside that design,
with its bound (the larger of the bytes at 3.35 TB/s and the int8
operations at 1,979 TOPS) and the card's name and power limit.

``--tile-n``, ``--vmem-mb`` and ``--int4`` are the TPU probe's flags. They do
not change either function (ops/b1_packed.py), so they are only checked
here: ``--tile-n`` must divide ``--db``, the probe's grid rule.

    python scripts/b1_kernel_probe_torch.py --check --device cpu
    python scripts/b1_kernel_probe_torch.py [--db 1048576] [--variant both]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mpc_iris_tpu_torch.benchmarks import (  # noqa: E402
    HBM_BYTES_PER_S,
    INT8_OPS,
    card_line,
    cuda_ms,
)
from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES  # noqa: E402
from mpc_iris_tpu_torch.ops.b1_packed import (  # noqa: E402
    pk_dot,
    pk_dot_winner,
    pk_select,
    prep_query,
)
from mpc_iris_tpu_torch.ops.packed_match import match_packed_int8_pairs  # noqa: E402
from mpc_iris_tpu_torch.ops.scan import _match_scan_packed, prepare_query_planes  # noqa: E402

SCAN_CHUNK = 65_536
VARIANTS = ("pk-dot", "pk-select")


def bound_ms(n: int, variant: str):
    """(ms, what) the card needs at least: the packed DB read once (and
    pk-dot's [32, N] int32 written), against the two int8 products of the
    32 query rows."""
    n_bytes = 2 * BITS_BYTES * n + 2 * 32 * BITS + (4 * 32 * n if variant == "pk-dot" else 12)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, 2 * 2 * 32 * BITS * n / INT8_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_variant(variant: str, qe, qm, pat, msk):
    if variant == "pk-dot":
        return pk_dot_winner(pk_dot(qe, qm, pat, msk))
    return pk_select(qe, qm, pat, msk)


def same_winner(got: torch.Tensor, want: torch.Tensor, exact: bool) -> bool:
    """Exact (n, d, idx), or the index and the exact fraction n/d."""
    (n1, d1, i1), (n2, d2, i2) = got.ravel().tolist(), want.ravel().tolist()
    if exact:
        return (n1, d1, i1) == (n2, d2, i2)
    return i1 == i2 and n1 * d2 == n2 * d1 and (d1 > 0) == (d2 > 0)


def check(variants, dev: torch.device) -> int:
    """The probe's --check on the CPU (or the card): 4,096 random entries,
    the query a copy of entry 17."""
    rng = np.random.default_rng(5)
    n = 4096
    pat = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, (n, BITS_BYTES), dtype=np.uint8)
    qpat = torch.from_numpy(pat[17:18].copy()).to(dev)
    qmsk = torch.from_numpy(msk[17:18].copy()).to(dev)
    pat, msk = torch.from_numpy(pat).to(dev), torch.from_numpy(msk).to(dev)
    q_enc, q_mask = prepare_query_planes(qpat, qmsk)
    want = _match_scan_packed(q_enc, q_mask, pat.reshape(2, n // 2, BITS_BYTES),
                              msk.reshape(2, n // 2, BITS_BYTES), fused=False)
    qe, qm = prep_query(qpat, qmsk)
    for variant in variants:
        got = run_variant(variant, qe, qm, pat, msk)
        if not torch.equal(got.ravel(), want.ravel()):
            print(f"{variant} != _match_scan_packed: {got.ravel().tolist()} vs "
                  f"{want.ravel().tolist()}")
            return 1
        print(f"{variant} == _match_scan_packed (unfused) on {dev} "
              f"[winner idx {int(got.ravel()[2])}]")
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--db", type=int, default=1_048_576)
    p.add_argument("--tile-n", type=int, default=512)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--vmem-mb", type=int, default=None)
    p.add_argument("--int4", action="store_true")
    p.add_argument("--variant", choices=[*VARIANTS, "both"], default="both")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    variants = VARIANTS if args.variant == "both" else (args.variant,)
    if args.tile_n < 1 or args.db % args.tile_n:
        p.error(f"--tile-n {args.tile_n} must divide --db {args.db}")
    dev = torch.device(args.device)
    if args.check:
        return check(variants, dev)
    if dev.type != "cuda" or not torch.cuda.is_available():
        print("b1_kernel_probe_torch: the timed run needs a CUDA card (--check runs on "
              "the CPU)", file=sys.stderr)
        return 1
    name = card_line()
    n = args.db
    rng = np.random.default_rng(args.seed)
    qpat = torch.from_numpy(rng.integers(0, 256, (1, BITS_BYTES), dtype=np.uint8)).to(dev)
    qmsk = torch.from_numpy(rng.integers(0, 256, (1, BITS_BYTES), dtype=np.uint8)).to(dev)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    pat = torch.randint(0, 256, (n, BITS_BYTES), generator=g, device=dev, dtype=torch.uint8)
    msk = torch.randint(0, 256, (n, BITS_BYTES), generator=g, device=dev, dtype=torch.uint8)
    qe, qm = prep_query(qpat, qmsk)
    q_enc, q_mask = prepare_query_planes(qpat, qmsk)

    chunks = n // SCAN_CHUNK if n % SCAN_CHUNK == 0 else 1
    want = _match_scan_packed(q_enc, q_mask, pat.reshape(chunks, n // chunks, BITS_BYTES),
                              msk.reshape(chunks, n // chunks, BITS_BYTES), fused=False)
    packed_b = (q_enc, q_mask, pat.reshape(1, n, BITS_BYTES), msk.reshape(1, n, BITS_BYTES))
    b_win = match_packed_int8_pairs(*packed_b)
    ok = torch.equal(b_win, want)
    print(f"int8 match kernel at qg=2, nq=1 == unfused scan: {ok} "
          f"[winner {want.ravel().tolist()}]")
    b_ms = cuda_ms(lambda: match_packed_int8_pairs(*packed_b), args.iters)
    print(f"time int8 match kernel at qg=2, nq=1 N={n}: {b_ms:.4f} ms [{name}]")
    for variant in variants:
        got = run_variant(variant, qe, qm, pat, msk)
        same = same_winner(got, want, exact=variant == "pk-select")
        ok &= same
        print(f"{variant} winner {got.ravel().tolist()} == unfused scan and the int8 kernel "
              f"{'(exact)' if variant == 'pk-select' else '(index and fraction)'}: {same}")
        t_bound, by = bound_ms(n, variant)
        k_ms = cuda_ms(lambda: run_variant(variant, qe, qm, pat, msk), args.iters)
        line = f"time {variant} N={n} tile_n={args.tile_n}: {k_ms:.4f} ms"
        if variant == "pk-dot":
            d_ms = cuda_ms(lambda: pk_dot(qe, qm, pat, msk), args.iters)
            line += f" (kernel {d_ms:.4f} ms, epilogue {k_ms - d_ms:.4f})"
            k_ms = d_ms
        print(f"{line}; bound {t_bound:.4f} ms ({by}), {t_bound / k_ms:.1%} of it; "
              f"int8 (qg=2, nq=1) {b_ms:.4f} ms [{name}]", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
