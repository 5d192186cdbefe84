"""Old against new design of the port's two redesigned probe kernels, on one
card in one process: ``int8_gemm`` (csrc/int8_gemm.cu) and the serial fused
keyed kernel (csrc/keyed_share_dot.cu, ``variant="serial"``), each beside
its yardstick, and the pipelined variant, whose code did not change, re-timed
beside them.

The old design is built from a directory holding an earlier commit's
``mpc_iris_tpu_torch/csrc`` (its int8_gemm.cu and keyed_share_dot.cu with
the headers they include), unpacked beforehand, for example

    git archive <commit> mpc_iris_tpu_torch/csrc | tar -x -C build/parent
    python scripts/probe_kernels_old_vs_new_torch.py \\
        --old build/parent/mpc_iris_tpu_torch/csrc --out build/old_vs_new.json

It is compiled by nvcc (the flags of ``ops/_build.py``) into its own library
under ``mpc_iris_tpu_torch/build/`` and called through its own C interface
(``int8_gemm_launch`` with the query laid out by ``wgmma_slabs``,
``keyed_share_dots_launch``). The new design is the package's.

Measured, CUDA events, in turns (old, new, new, old; the median of each
design's two turns): ``int8_gemm`` at [M x 12,800] . [16,384 x 12,800] for
M = 31, 248, 4,096 (the keyed pass at B = 1, 8 and the scan's products at
B = 128) beside ``torch._int_mm``; the keyed kernels on a 16,384-row chunk
at B = 1 and 8 beside kernel (d) alone and kernel (d) + ``dot_share_batch``.
Each design is timed as its wrapper ran it (the per-call query layout
included) and as its kernel alone (operands prepared once).
Every output is checked bit for bit: old against new, and the products
against ``torch._int_mm``. Then, from ``cuobjdump -sass`` of the package's
library, the instruction mix of ChaCha20 in kernel (d) and in the serial
kernel's stage loop, by pipe, and the bound it gives (a 16-lane integer pipe
for the xor, funnel-shift and byte-permute instructions: 64 lanes an SM a
clock). Prints the card's name, power limit and SM clock. Needs a CUDA card.
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
from collections import Counter

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mpc_iris_tpu_torch.constants import BITS  # noqa: E402
from mpc_iris_tpu_torch.ops import _build  # noqa: E402
from mpc_iris_tpu_torch.ops.chacha import key_tensor, share_planes_kernel  # noqa: E402
from mpc_iris_tpu_torch.ops.dot import dot_share_batch  # noqa: E402
from mpc_iris_tpu_torch.ops.gemm import int8_gemm, wgmma_slabs  # noqa: E402
from mpc_iris_tpu_torch.ops.keyed_dot import (  # noqa: E402
    _file_order_index,
    block_shape,
    keyed_share_dots,
    query_slabs,
    serial_shape,
)

CHUNK = 16_384
PRODUCT_ROWS = (31, 248, 4_096)
BATCHES = (1, 8)
REPS = 20
KEY = bytes(range(0x80, 0xA0))
BLOCKS_PER_CHUNK = CHUNK * 400
SM_ALU_LANES = 64  # the integer pipe: 16 lanes on each of an SM's 4 partitions
ALU_PIPE = ("LOP3", "SHF", "PRMT", "IADD3", "ISETP", "SEL", "LEA", "IABS", "BMSK")
FMA_PIPE = ("IMAD", "FFMA", "FADD", "FMUL")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(old, new) -> tuple[float, float]:
    """Old, new, new, old: each design's median of its two turns (ms)."""
    o1, n1, n2, o2 = cuda_ms(old), cuda_ms(new), cuda_ms(new), cuda_ms(old)
    return float(np.median([o1, o2])), float(np.median([n1, n2]))


def build_old(csrc: str) -> ctypes.CDLL:
    names = ("int8_gemm.cu", "keyed_share_dot.cu")
    h = hashlib.sha256()
    for f in sorted(os.listdir(csrc)):
        h.update(f.encode())
        with open(os.path.join(csrc, f), "rb") as fh:
            h.update(fh.read())
    out = _build.BUILD_DIR / f"libold_probe_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(out),
                        *(os.path.join(csrc, n) for n in names)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.int8_gemm_launch.argtypes = [i, p, p, i, i, i, p, p]
    lib.keyed_share_dots_launch.argtypes = [i, i, i, p, p, p, u, u, i, i, p, p]
    lib.int8_gemm_launch.restype = lib.keyed_share_dots_launch.restype = i
    return lib


def old_gemm(lib, q: torch.Tensor, db: torch.Tensor, prepared: bool):
    """The old int8_gemm: per call the query laid out in wgmma slabs of 32,
    64 or 128 rows (``prepared``: once, outside the timed call), one block
    per (query tile, 256 DB rows)."""
    (m, k), n = q.shape, db.shape[0]
    rows = next((t for t in (32, 64, 128) if m <= t), 128)
    fixed = wgmma_slabs(q, rows) if prepared else None
    out = torch.empty((m, n), dtype=torch.int32, device=q.device)

    def run():
        at = fixed if prepared else wgmma_slabs(q, rows)
        rc = lib.int8_gemm_launch(rows, at.data_ptr(), db.data_ptr(), m, n, k, out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old int8_gemm launch failed: {rc}")
        return out
    return run


def keyed_operands(q_nat: torch.Tensor, rows: int, old: bool):
    """A keyed kernel's query slabs (the old wrapper's gather and
    ``wgmma_slabs``, or the new ``query_slabs``), correction and output."""
    if old:
        qt = wgmma_slabs(q_nat[:, _file_order_index(q_nat.device)], rows)
    else:
        qt = query_slabs(q_nat, rows)
    corr = 128 * q_nat.sum(dim=1, dtype=torch.int32)
    return qt, corr, torch.empty((q_nat.shape[0], CHUNK), dtype=torch.int32, device=q_nat.device)


def keyed_run(launch, args, q_nat, kw, rows: int, old: bool, prepared: bool):
    """A keyed kernel's call on rows [0, CHUNK) of stream 0: the wrapper's
    per-call operands and the launch, or (``prepared``) the launch alone."""
    fixed = keyed_operands(q_nat, rows, old) if prepared else None

    def run():
        qt, corr, out = fixed or keyed_operands(q_nat, rows, old)
        rc = launch(*args, qt.data_ptr(), corr.data_ptr(), kw.data_ptr(), 0, 0, CHUNK,
                    q_nat.shape[0], out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"keyed launch failed: {rc}")
        return out
    return run


def keyed_runs(old_lib, q_nat, kw, variant: str, prepared: bool):
    """(old, new) runs of one variant: the old library's launch with the old
    shapes (block_shape for both variants), the package's with its own."""
    m = q_nat.shape[0]
    wr, qw = block_shape(m)
    pipe_rows = 2 * qw if wr == 1 else qw
    old = keyed_run(old_lib.keyed_share_dots_launch, (int(variant == "pipelined"), wr, qw),
                    q_nat, kw, pipe_rows, True, prepared)
    lib = _build.library()
    if variant == "serial":
        shape = serial_shape(m)
        new = keyed_run(lib.keyed_share_dots_serial_launch, shape.launch_args, q_nat, kw,
                        shape.query_rows, False, prepared)
    else:
        new = keyed_run(lib.keyed_share_dots_pipe_launch, (wr, qw), q_nat, kw, pipe_rows, False,
                        prepared)
    return old, new


def sass_functions(path: str) -> dict:
    """SASS opcodes of each kernel of a library (cuobjdump -sass)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def pipe_mix(ops: list, blocks: int) -> dict:
    """Per ChaCha block: integer-pipe, FMA-pipe and all instructions of a
    stretch of SASS that makes ``blocks`` blocks."""
    heads = Counter(op.split(".")[0] for op in ops)
    alu = sum(heads[o] for o in ALU_PIPE)
    fma = sum(heads[o] for o in FMA_PIPE)
    return {"alu": alu / blocks, "fma": fma / blocks, "all": len(ops) / blocks,
            "opcodes": dict(heads.most_common(8))}


def sass_bound(sm_clock_mhz: float, sms: int) -> dict:
    """The ChaCha20 instruction mix of kernel (d) (one block a thread) and of
    the serial kernel's stage loop at B = 1 and 8 (between its first barrier
    and its backward branch), and the chunk bound it gives on the integer
    pipe."""
    funcs = sass_functions(str(_build.build().path))
    out = {}
    for name, ops in funcs.items():
        if "chacha_planes_kernel" in name:
            out["kernel (d)"] = pipe_mix(ops, 1)
        m = re.search(r"keyed_share_dot_serial_kernelILi(\d+)ELi(\d)ELi(\d)E", name)
        if m and m.group(1) in ("32", "256"):
            first = ops.index("BAR.SYNC.DEFER_BLOCKING")
            last = max(i for i, op in enumerate(ops) if op == "BAR.SYNC.DEFER_BLOCKING"
                       and i < len(ops) - 1 and "BRA" in ops[i + 1])
            out[f"serial QW={m.group(1)}"] = pipe_mix(ops[first:last + 2], int(m.group(2)))
    # the rounds alone: 4 adds, 4 xors, 4 rotates a quarter round, 80 of them,
    # and 16 adds of the input; xor and rotate on the integer pipe
    clocks = BLOCKS_PER_CHUNK * 640 / SM_ALU_LANES / sms
    out["bound"] = {"alu_per_block": 640, "sm_clock_mhz": sm_clock_mhz,
                    "chunk_ms": clocks / (sm_clock_mhz * 1e3)}
    for what, mix in out.items():
        if "alu" in mix:
            mix["chunk_ms_at_alu"] = BLOCKS_PER_CHUNK * mix["alu"] / SM_ALU_LANES / sms / (
                sm_clock_mhz * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="the earlier commit's mpc_iris_tpu_torch/csrc")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    old = build_old(args.old)
    rng = np.random.default_rng(0)
    res = {"card": card, "script": "scripts/probe_kernels_old_vs_new_torch.py", "gemm": {},
           "keyed": {}}
    ok = True

    db = torch.from_numpy(rng.integers(-128, 128, (CHUNK, BITS), dtype=np.int8)).to(dev)
    for m in PRODUCT_ROWS:
        q = torch.from_numpy(rng.integers(-1, 2, (m, BITS), dtype=np.int8)).to(dev)
        want = torch._int_mm(q, db.T)
        equal = (torch.equal(old_gemm(old, q, db, False)(), want)
                 and torch.equal(int8_gemm(q, db), want))
        ok &= equal
        o_ms, n_ms = in_turns(old_gemm(old, q, db, False), lambda: int8_gemm(q, db))
        ok_ms, _ = in_turns(old_gemm(old, q, db, True), lambda: int8_gemm(q, db))
        lib_ms = cuda_ms(lambda: torch._int_mm(q, db.T))
        res["gemm"][m] = {"old_ms": o_ms, "new_ms": n_ms, "old_kernel_ms": ok_ms,
                          "int_mm_ms": lib_ms, "equal": equal}
        print(f"int8_gemm M={m}: old {o_ms:.4f} ms (its kernel alone {ok_ms:.4f}), new "
              f"{n_ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms; bit-equal {equal} [{card}]")
        del want

    kw = key_tensor(KEY, dev)
    for b in BATCHES:
        q = torch.from_numpy(rng.integers(-1, 2, (31 * b, BITS), dtype=np.int8)).to(dev)
        rec = {}
        for variant in ("serial", "pipelined"):
            old_call, new_call = keyed_runs(old, q, kw, variant, False)
            old_kernel, new_kernel = keyed_runs(old, q, kw, variant, True)
            want = keyed_share_dots(q, kw, 0, 0, CHUNK, variant=variant)
            equal = all(torch.equal(f(), want) for f in (old_call, new_call, old_kernel,
                                                         new_kernel))
            ok &= equal
            o_ms, n_ms = in_turns(old_call, new_call)
            ok_ms, nk_ms = in_turns(old_kernel, new_kernel)
            rec[variant] = {"old_ms": o_ms, "new_ms": n_ms, "old_kernel_ms": ok_ms,
                            "new_kernel_ms": nk_ms, "equal": equal}
        rec["d_ms"] = cuda_ms(lambda: share_planes_kernel(kw, 0, 0, CHUNK))
        rec["d_products_ms"] = cuda_ms(
            lambda: dot_share_batch(q, *share_planes_kernel(kw, 0, 0, CHUNK)))
        res["keyed"][b] = rec
        for variant in ("serial", "pipelined"):
            r = rec[variant]
            print(f"keyed chunk {CHUNK} rows B={b} {variant}: old {r['old_ms']:.4f} ms, new "
                  f"{r['new_ms']:.4f} ms (the kernel alone, operands prepared once: old "
                  f"{r['old_kernel_ms']:.4f}, new {r['new_kernel_ms']:.4f}); bit-equal "
                  f"{r['equal']} [{card}]")
        print(f"keyed chunk {CHUNK} rows B={b}: kernel (d) alone {rec['d_ms']:.4f} ms, (d) + "
              f"products {rec['d_products_ms']:.4f} ms [{card}]")

    max_mhz = float(card.split(",")[-1].strip().split()[0])
    res["sass"] = sass_bound(max_mhz, torch.cuda.get_device_properties(dev).multi_processor_count)
    for what, mix in res["sass"].items():
        print(f"sass {what}: {json.dumps(mix)}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(f"all outputs bit-equal: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
