#!/usr/bin/env python3
"""Time variants of the port's packed small-batch kernels (b) and (c) on one
CUDA card, to find what bounds them.

Each variant is a copy of ``mpc_iris_tpu_torch`` in a temporary directory
with text substitutions in ``csrc/packed_tile.cuh`` (and, for the swizzled
layout, ``ops/packed_match.py``), built there and run in its own process:
first both kernels against their plain versions at B = 1, 2, 3, 8, 9 on a
1,500-entry DB, then ``match_packed_small_b`` over a 1,048,576-entry packed
DB at B = 1, 2, 4, 8, 16 and at B = 8 in groups of 2 (CUDA events, mean of 3
after a warm-up). Variants marked "timing only" compute wrong results on
purpose (they drop work to see whether it costs time); for them the check
prints MISMATCH and goes on.

    python3 scripts/packed_tile_variants.py [VARIANT ...]

The substitutions name lines of the current sources; a variant whose text is
gone fails with an AssertionError.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile

_NO_QUERY_PIPE = [
    ("          mbar_wait(q_full + 8 * qs, (step / kQStages) & 1);\n", ""),
    ("          if (threadIdx.x == 0 && step + kQStages - kRefillLag < kSteps) {",
     "          if (false) {"),
]
_NO_DB_PIPE = [
    ("      if (js + kDbStages - 1 < kPlane / C::kDbBytes) fetch_db(js + kDbStages - 1);\n", ""),
    ("      mbar_wait(d_full + 8 * ds, (js / kDbStages) & 1);\n", ""),
    ("    for (int js = 0; js < kDbStages - 1; ++js) fetch_db(js);\n", ""),
    ("        if (jh == C::kDbBytes / 32 - 1) mbar_arrive(d_empty + 8 * ds);\n", ""),
]
# name -> (what it changes, substitutions in packed_tile.cuh)
VARIANTS = {
    "base": ("the sources as they are", []),
    "lag1": ("refill a query slot one step after its release (lockstep)",
             [("kRefillLag = 2", "kRefillLag = 1")]),
    "pend2": ("two wgmma groups in flight per warpgroup, refill lag 3",
              [("kPending = 1", "kPending = 2"), ("kRefillLag = 2", "kRefillLag = 3")]),
    "fp8": ("timing only: the same wgmma typed e4m3 x e4m3 -> f32", "AS_FP8"),
    "sw32": ("query slabs in the 32-byte swizzled K-major layout", [
        ("  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | "
         "(static_cast<uint64_t>(128 >> 4) << 16) |\n"
         "         (static_cast<uint64_t>(256 >> 4) << 32);",
         "  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |\n"
         "         (static_cast<uint64_t>(256 >> 4) << 32) | (static_cast<uint64_t>(3) << 62);"),
        ("extern __shared__ __align__(128) uint8_t smem[];",
         "extern __shared__ __align__(1024) uint8_t smem[];")]),
    "ss": ("timing only: wgmma's A from shared memory (the query slab) instead of "
           "the unpacked registers", "A_FROM_SHARED"),
    "noalu": ("timing only: the raw packed words as A, no unpacking", [
        ("              am[mt][i] = (m[mt][i] >> b) & kLsb;\n"
         "              ae[mt][i] = ((pm[mt][i] >> b) & kLsb) * 0xFEu + am[mt][i];",
         "              am[mt][i] = m[mt][i];\n              ae[mt][i] = pm[mt][i];")]),
    "nofence": ("timing only: no register fences on the A fragments", [
        ("              reg_fence(am[mt][i]);\n              reg_fence(ae[mt][i]);", "")]),
    "noq": ("timing only: no query-slab copies or waits", _NO_QUERY_PIPE),
    "nodb": ("timing only: no DB-stage copies or waits", _NO_DB_PIPE),
    "nopipe": ("timing only: no copies or waits at all", _NO_QUERY_PIPE + _NO_DB_PIPE),
}
# the swizzled layout's query tiles: 16-byte K halves swapped in rows 4..7 of
# every 8-row group
_SW32_PY = [("    return torch.stack([operand(q_enc), operand(q_mask)], dim=3).contiguous()",
             "    x = torch.stack([operand(q_enc), operand(q_mask)], dim=3).transpose(-3, -2)\n"
             "    x = torch.cat([x[..., :4, :, :], x[..., 4:, :, :].flip(-2)], dim=-3)\n"
             "    return x.contiguous()")]

RUN = r'''
import numpy as np
import torch
from mpc_iris_tpu_torch.ops._build import build
from mpc_iris_tpu_torch.ops import packed_match as tpm
from mpc_iris_tpu_torch.ops.scan import prepare_query_planes

log = build().log.splitlines()
for i, line in enumerate(log):
    if "Compiling entry function" in line and "packed_match_kernel" in line:
        for l in log[i + 1:i + 4]:
            if "Used" in l or "spill stores" in l:
                print("    ptxas", line.split("kernelILi")[1][:8], l.split(":", 1)[-1].strip())
dev = torch.device("cuda")
rng = np.random.default_rng(5)
for bb in (1, 2, 3, 8, 9):
    pat, msk, qpat, qmsk = tpm.planted_packed_case(rng, n=1500, b=bb)
    db = [torch.from_numpy(np.pad(x, ((0, 100), (0, 0)))).reshape(4, 400, 1600).to(dev)
          for x in (pat, msk)]
    q = prepare_query_planes(torch.from_numpy(qpat).to(dev), torch.from_numpy(qmsk).to(dev))
    a = (*q, *db)
    ok = torch.equal(tpm.match_packed_small_b(*a), tpm.match_packed_small_b_reference(*a))
    ok &= torch.equal(tpm.fractions_packed_small_b(*a), tpm.fractions_packed_small_b_reference(*a))
    if not ok:
        print(f"    MISMATCH against the plain version at B={bb}")
n = 1 << 20
g = torch.Generator(device=dev)
g.manual_seed(1)
pat, msk = (torch.randint(0, 256, (64, n // 64, 1600), dtype=torch.uint8, device=dev,
                          generator=g) for _ in range(2))
q_enc, q_mask = prepare_query_planes(pat.reshape(n, 1600)[:16].clone(),
                                     msk.reshape(n, 1600)[16:32].clone())


def ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


out = []
for bb in (1, 2, 4, 8, 16):
    a = (q_enc[:bb], q_mask[:bb], pat, msk)
    out.append(f"B={bb} {ms(lambda: tpm.match_packed_small_b(*a)):.3f}")
tpm._launch_plan = lambda b: [(0, b, 2)]
a = (q_enc[:8], q_mask[:8], pat, msk)
out.append(f"B=8 in groups of 2 {ms(lambda: tpm.match_packed_small_b(*a)):.3f}")
print("    match_packed_small_b N=1048576, ms:", " | ".join(out), flush=True)
'''


def _substitute(path: str, subs) -> None:
    with open(path) as f:
        src = f.read()
    if subs == "A_FROM_SHARED":  # wgmma's A operand: the B descriptor, not registers
        src, k = re.subn(r'"\{%(\d+), %(\d+), %(\d+), %(\d+)\}, %(\d+), p;', r'"%\5, %\5, p;', src)
        assert k == 3, k
    elif subs == "AS_FP8":  # the wgmma wrappers' type and accumulator registers
        src, k = re.subn(r"\.s32\.s8\.s8 ", ".f32.e4m3.e4m3 ", src)
        assert k == 3, k
        src = re.sub(r'"\+r"\(d\[(\d+)\]\)', r'"+f"(*reinterpret_cast<float*>(&d[\1]))', src)
        src, k = re.subn(r'%(\d+), p;\\n\}\\n"', r'%\1, p, 1, 1;\\n}\\n"', src)
        assert k == 3, k
    else:
        for old, new in subs:
            assert src.count(old) == 1, old
            src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)


def calibrate() -> None:
    """The card's tensor-core rates through library GEMMs, 8192^3 (CUDA
    events, mean of 20): int8 (torch._int_mm), bf16 (matmul), fp8 e4m3
    (torch._scaled_mm) -- a yardstick for what these shapes reach here."""
    import torch

    dev = torch.device("cuda")
    n = 8192

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    x = torch.randint(-128, 128, (n, n), dtype=torch.int8, device=dev)
    y = torch.randint(-128, 128, (n, n), dtype=torch.int8, device=dev).t()
    a = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    a8 = a.to(torch.float8_e4m3fn)
    b8 = b.t().contiguous().to(torch.float8_e4m3fn).t()
    one = torch.tensor(1.0, device=dev)
    rates = {"int8 torch._int_mm": ms(lambda: torch._int_mm(x, y)),
             "bf16 matmul": ms(lambda: a @ b),
             "fp8 e4m3 torch._scaled_mm": ms(lambda: torch._scaled_mm(
                 a8, b8, one, one, out_dtype=torch.bfloat16))}
    print("library GEMMs 8192^3:", " | ".join(
        f"{k} {v:.3f} ms = {2 * n**3 / v / 1e9:.0f} T ops/s" for k, v in rates.items()),
        flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("packed_tile_variants: no CUDA card available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    calibrate()
    pkg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "mpc_iris_tpu_torch")
    failed = 0
    for name in sys.argv[1:] or list(VARIANTS):
        what, subs = VARIANTS[name]
        with tempfile.TemporaryDirectory() as root:
            copy = os.path.join(root, "mpc_iris_tpu_torch")
            shutil.copytree(pkg, copy, ignore=shutil.ignore_patterns("build", "__pycache__"))
            _substitute(os.path.join(copy, "csrc", "packed_tile.cuh"), subs)
            if name == "sw32":
                _substitute(os.path.join(copy, "ops", "packed_match.py"), _SW32_PY)
            print(f"variant {name}: {what}", flush=True)
            r = subprocess.run([sys.executable, "-c", RUN], env={**os.environ, "PYTHONPATH": root},
                               timeout=300)
            if r.returncode:
                print(f"    variant {name} failed, exit code {r.returncode}", flush=True)
                failed += 1
    print(f"card: {card}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
