"""Old against new design of the port's redesigned probe kernels, on one
card in one process: ``int8_gemm`` (csrc/int8_gemm.cu), the serial fused
keyed kernel (csrc/keyed_share_dot.cu, ``variant="serial"``), the B = 1
pk-dot kernel, the B = 1 select kernel and the B = 1 spectrum kernel
(csrc/b1_packed.cu), each beside its yardstick, and the pipelined keyed
variant, whose code did not change, re-timed beside them. ``--kernels``
picks the families (default all five; ``pk_dot``'s old path takes a tree
whose pk-dot ran on kernel (b)'s tile loop, before the binary pk-dot:
``--kernels pk_dot`` against 0a389bc or earlier, ``--kernels pk_select``
against a tree whose B = 1 match ran the int8 kernel, 1324898 or earlier,
``--kernels pk_fractions`` against a tree whose B = 1 audit spectrum ran
the int8 kernel, baea42b or earlier).

The old design is built from a directory holding an earlier commit's
``mpc_iris_tpu_torch/csrc`` (its int8_gemm.cu, keyed_share_dot.cu,
b1_packed.cu and packed_match.cu with the headers they include), unpacked
beforehand, for example

    git archive <commit> mpc_iris_tpu_torch | tar -x -C build/parent
    python scripts/probe_kernels_old_vs_new_torch.py \
        --old build/parent/mpc_iris_tpu_torch/csrc --out build/old_vs_new.json

It is compiled by nvcc (the flags of ``ops/_build.py``) into its own library
under ``mpc_iris_tpu_torch/build/`` and called through its own C interface
(``int8_gemm_launch`` with the query laid out by ``wgmma_slabs``,
``keyed_share_dots_launch``, the ``pk_dot_launch(qt, dp, dm, n, out,
stream)`` of a tree whose pk-dot ran on kernel (b)'s tile loop, the query
laid out by ``_query_slabs``, for ``pk_select`` kernel (b)'s
``match_packed_small_b_launch`` with a group of one query, the int8 design
B = 1 ran before the binary select kernel, and for ``pk_fractions`` kernel
(c)'s ``fractions_packed_small_b_launch`` with a group of one query, the
query laid out by ``_query_tiles``). The new design is the package's.

Measured, CUDA events, in turns (old, new, new, old; the median of each
design's two turns): ``int8_gemm`` at [M x 12,800] . [16,384 x 12,800] for
M = 31, 248, 4,096 (the keyed pass at B = 1, 8 and the scan's products at
B = 128) beside ``torch._int_mm``; the keyed kernels on a 16,384-row chunk
at B = 1 and 8 beside kernel (d) alone and kernel (d) + ``dot_share_batch``.
Each design is timed as its wrapper ran it (the per-call query layout
included) and as its kernel alone (operands prepared once). pk-dot and
pk-select over 1,048,576 packed entries at B = 1 (made on the card from the
seed, with an all-masked and an all-set entry), the same way; pk-select
beside the int8 kernel at a group of 2 with one query
(``match_packed_int8_pairs``) and pk-dot, with ptxas's registers and spill
of the binary kernels and the ``BMMA`` count of their SASS; then
``PlaintextEngine.match`` at packed B = 1 and 5 over 1,048,576 entries and
the sharded B = 1 request (4 shards on the card), host wall, one
subprocess per package in turns (old, new, new, old), the old package being
the ``mpc_iris_tpu_torch`` directory that holds ``--old``. ``pk_fractions``
likewise: ``fractions_packed_small_b`` at B = 1 over 1,048,576 entries (64
chunks of 16,384) as a call and as a kernel, beside ``pk_select`` on the
same inputs and the int8 kernel at B = 2 (a group of 2), each spectrum
against ``fractions_packed_small_b_reference``; ptxas and the SASS ``BMMA``
count of the three b1 kernels; then ``PlaintextEngine.find_under`` (t =
0.375) and ``min_fractions`` at packed B = 1 and 5 and both sharded at
B = 1, in turns as above.
Every output is checked bit for bit: old against new, the products
against ``torch._int_mm``, pk-dot and pk-select against their plain
versions. Then, from ``cuobjdump -sass`` of the package's library, the
instruction mix of ChaCha20 in kernel (d) and in the serial kernel's stage
loop, by pipe, and the bound it gives (a 16-lane integer pipe for the xor,
funnel-shift and byte-permute instructions: 64 lanes an SM a clock). Prints
the card's name, power limit and SM clock. Needs a CUDA card.
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

from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES  # noqa: E402
from mpc_iris_tpu_torch.ops import _build  # noqa: E402
from mpc_iris_tpu_torch.ops.b1_packed import (  # noqa: E402
    ROT_BITREV,
    launch_fractions,
    launch_select,
    pk_dot,
    pk_dot_operand,
    pk_dot_reference,
    pk_select,
    pk_select_reference,
    prep_query,
)
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
from mpc_iris_tpu_torch.ops.packed_match import (  # noqa: E402
    _bitplane_perm,
    _one_query_operand,
    _query_tiles,
    fractions_packed_small_b,
    fractions_packed_small_b_reference,
    match_packed_int8_pairs,
)
from mpc_iris_tpu_torch.ops.select import N_ROT_PAD  # noqa: E402

CHUNK = 16_384
PK_DB = 1_048_576
KERNELS = ("gemm", "keyed", "pk_dot", "pk_select", "pk_fractions")
FILES = {"gemm": "int8_gemm.cu", "keyed": "keyed_share_dot.cu", "pk_dot": "b1_packed.cu",
         "pk_select": "packed_match.cu", "pk_fractions": "packed_fractions.cu"}
B1_KERNELS = ("pk_dot_kernel", "pk_select_kernel", "pk_fractions_kernel")
REQUEST_BATCHES = (1, 5)
REQUEST_REPS = 20
PK_BOUND_MS = 1.0019  # pk-select's: 3.36 GB of packed DB at 3.35 TB/s (chip_smoke.py)
# pk-fractions': the same DB and query read, 4 bytes an entry written
PK_FRACTIONS_BOUND_MS = 1.0031
AUDIT_T = 0.375
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


def build_old(csrc: str, kernels=KERNELS) -> ctypes.CDLL:
    names = sorted({FILES[k] for k in kernels})
    h = hashlib.sha256()
    for f in sorted(os.listdir(csrc)):
        h.update(f.encode())
        with open(os.path.join(csrc, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(names).encode())
    out = _build.BUILD_DIR / f"libold_probe_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(out),
                        *(os.path.join(csrc, n) for n in names)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_longlong
    signatures = {"int8_gemm_launch": [i, p, p, i, i, i, p, p],
                  "keyed_share_dots_launch": [i, i, i, p, p, p, u, u, i, i, p, p],
                  "pk_dot_launch": [p, p, p, ll, p, p],
                  "packed_tile_entries": [i],
                  "match_packed_small_b_launch": [i, p, p, p, ll, i, p, p, i, p],
                  "fractions_packed_small_b_launch": [i, p, p, p, ll, i, p, ll, p]}
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i
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


def pk_inputs(n: int, seed: int, dev: torch.device):
    """(qe, qm, pat, msk): a random packed query through ``prep_query`` and
    a packed DB [n, 1600] made on the card from the seed, entry 0 all masked
    (den = 0) and the last entry all set."""
    rng = np.random.default_rng(seed)
    qpat, qmsk = (torch.from_numpy(rng.integers(0, 256, (1, BITS_BYTES), dtype=np.uint8)).to(dev)
                  for _ in range(2))
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    pat, msk = (torch.randint(0, 256, (n, BITS_BYTES), generator=g, device=dev,
                              dtype=torch.uint8) for _ in range(2))
    msk[0] = 0
    pat[-1] = msk[-1] = 255
    return (*prep_query(qpat, qmsk), pat, msk)


def _query_slabs(qe: torch.Tensor, qm: torch.Tensor) -> torch.Tensor:
    """(qe, qm) int8 [32, 12,800] -> int8 [50, 8, 2, 4, 2, 8, 16], kernel
    (b)'s query operand of one query (``packed_tile.cuh``): per K-step (byte
    slab jj, bit-plane b) the encoding and the mask slab of 32 rows x 32
    bytes, in the order wgmma reads them from shared memory (8-row groups,
    the two 16-byte K halves, 8 rows, 16 bytes). K is already
    bit-plane-major, k = b * 1600 + jj * 32 + (0..31); the rows stay in the
    given order."""
    def operand(q):
        x = q.reshape(N_ROT_PAD // 8, 8, 8, BITS_BYTES // 32, 2, 16)  # nh, nl, b, jj, kh, kl
        return x.permute(3, 2, 0, 4, 1, 5)                           # jj, b, nh, kh, nl, kl

    return torch.stack([operand(qe), operand(qm)], dim=2).contiguous()


def old_pk_dot(lib, qe, qm, pat, msk, prepared: bool):
    """The old pk-dot: kernel (b)'s tile loop with one query, its operand
    laid out by ``_query_slabs`` per call (``prepared``: once)."""
    fixed = _query_slabs(qe, qm) if prepared else None
    out = torch.empty((32, pat.shape[0]), dtype=torch.int32, device=qe.device)

    def run():
        qt = fixed if prepared else _query_slabs(qe, qm)
        rc = lib.pk_dot_launch(qt.data_ptr(), pat.data_ptr(), msk.data_ptr(), pat.shape[0],
                               out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old pk_dot launch failed: {rc}")
        return out
    return run


def new_pk_dot_kernel(qe, qm, pat, msk):
    """The package's pk-dot kernel alone: its operand laid out once."""
    a = pk_dot_operand(qe, qm)
    out = torch.empty((32, pat.shape[0]), dtype=torch.int32, device=qe.device)
    lib = _build.library()

    def run():
        _build.check_launch("pk_dot", lib.pk_dot_launch(
            a.data_ptr(), pat.data_ptr(), msk.data_ptr(), pat.shape[0], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream))
        return out
    return run


def pk_dot_turns(old, card: str) -> dict:
    """Old against new pk-dot over PK_DB entries, as the wrappers run them
    and as kernels alone, each output against pk_dot_reference."""
    args = pk_inputs(PK_DB, 0, torch.device("cuda"))
    want = pk_dot_reference(*args)
    runs = {"old": old_pk_dot(old, *args, False), "new": lambda: pk_dot(*args),
            "old_kernel": old_pk_dot(old, *args, True), "new_kernel": new_pk_dot_kernel(*args)}
    equal = all(torch.equal(f(), want) for f in runs.values())
    del want
    o_ms, n_ms = in_turns(runs["old"], runs["new"])
    ok_ms, nk_ms = in_turns(runs["old_kernel"], runs["new_kernel"])
    rec = {"old_ms": o_ms, "new_ms": n_ms, "old_kernel_ms": ok_ms, "new_kernel_ms": nk_ms,
           "equal": equal, "entries": PK_DB}
    print(f"pk_dot N={PK_DB} B=1: old {o_ms:.4f} ms, new {n_ms:.4f} ms (the kernel alone, "
          f"operand prepared once: old {ok_ms:.4f}, new {nk_ms:.4f}); speed-up "
          f"{o_ms / n_ms:.2f}x; bit-equal to pk_dot_reference {equal} [{card}]")
    return rec


def old_pk_select(lib, qe, qm, pat, msk, prepared: bool):
    """The old pk-select: kernel (b)'s int8 match kernel with a group of one
    query (qg = 1), its operand the rows put back in rotation order, laid
    out by ``_query_slabs`` per call (``prepared``: once)."""
    rev = torch.as_tensor(ROT_BITREV, device=qe.device)
    fixed = _query_slabs(qe[rev], qm[rev]) if prepared else None
    n = pat.shape[0]
    part = torch.empty(3 * -(-n // lib.packed_tile_entries(1)), dtype=torch.int32,
                       device=qe.device)
    out = torch.empty((3, 1), dtype=torch.int32, device=qe.device)

    def run():
        qt = fixed if prepared else _query_slabs(qe[rev], qm[rev])
        rc = lib.match_packed_small_b_launch(1, qt.data_ptr(), pat.data_ptr(), msk.data_ptr(),
                                             n, 1, part.data_ptr(), out.data_ptr(), 1,
                                             torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old pk_select launch failed: {rc}")
        return out
    return run


def new_pk_select_kernel(qe, qm, pat, msk):
    """The package's pk-select kernel and its fold alone: its operand laid
    out once, no query check."""
    rev = torch.as_tensor(ROT_BITREV, device=qe.device)
    a = pk_dot_operand(qe[rev], qm[rev])
    out = torch.empty((3, 1), dtype=torch.int32, device=qe.device)
    lib = _build.library()

    def run():
        launch_select("pk_select", lib, a, pat, msk, pat.shape[0], out, 1)
        return out
    return run


def ptxas_lines(kernel: str) -> list[str]:
    """ptxas's registers and spill lines for ``kernel`` in csrc/b1_packed.cu,
    compiled here to an object with the package's flags (``-Xptxas -v``)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = _build.BUILD_DIR / f"ptxas_b1_packed_{os.getpid()}.o"
    try:
        log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(obj),
                              str(_build.CSRC / "b1_packed.cu")], capture_output=True,
                             text=True, check=True)
    finally:
        obj.unlink(missing_ok=True)
    lines, mine = [], False
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry function" in line:
            mine = kernel in line
        elif mine and ("registers" in line or "spill" in line):
            lines.append(line.split("ptxas info    :")[-1].strip())
    return lines


def route_planes(qe: torch.Tensor, qm: torch.Tensor):
    """prep_query's pair -> int8 [1, 31, 12,800] x2 as prepare_query_planes
    gives them: the rows back in rotation order, the dummy dropped, K back in
    the natural order."""
    rev = torch.as_tensor(ROT_BITREV, device=qe.device)
    inv = torch.empty(BITS, dtype=torch.long, device=qe.device)
    inv[torch.as_tensor(_bitplane_perm(), device=qe.device)] = torch.arange(BITS,
                                                                           device=qe.device)
    return tuple(x[rev][:31].unsqueeze(0)[..., inv] for x in (qe, qm))


def b1_build_lines() -> tuple[dict, dict]:
    """The SASS BMMA count and ptxas's lines of each b1 kernel."""
    sass = sass_functions(str(_build.build().path))
    bmma = {k: sum(op.startswith("BMMA") for op in ops) for name, ops in sass.items()
            for k in B1_KERNELS if k in name}
    return bmma, {k: ptxas_lines(k) for k in B1_KERNELS}


def pk_select_turns(old, card: str) -> dict:
    """Old against new pk-select over PK_DB entries at B = 1, as the
    wrappers run them and as kernels alone, each output against
    pk_select_reference; beside them the int8 kernel at a group of 2 with
    one query and pk-dot; ptxas's lines and the SASS BMMA count of both b1
    kernels."""
    args = pk_inputs(PK_DB, 0, torch.device("cuda"))
    qe, qm, pat, msk = args
    want = pk_select_reference(*args)
    q_enc, q_mask = route_planes(qe, qm)
    db = (pat.view(1, -1, BITS_BYTES), msk.view(1, -1, BITS_BYTES))
    runs = {"old": old_pk_select(old, *args, False), "new": lambda: pk_select(*args),
            "old_kernel": old_pk_select(old, *args, True),
            "new_kernel": new_pk_select_kernel(*args),
            "int8_pair": lambda: match_packed_int8_pairs(q_enc, q_mask, *db)}
    equal = all(torch.equal(f(), want) for f in runs.values())
    o_ms, n_ms = in_turns(runs["old"], runs["new"])
    ok_ms, nk_ms = in_turns(runs["old_kernel"], runs["new_kernel"])
    pair_ms = cuda_ms(runs["int8_pair"])
    dot_ms = cuda_ms(lambda: pk_dot(*args))
    bmma, ptxas = b1_build_lines()
    rec = {"old_ms": o_ms, "new_ms": n_ms, "old_kernel_ms": ok_ms, "new_kernel_ms": nk_ms,
           "int8_pair_ms": pair_ms, "pk_dot_ms": dot_ms, "bound_ms": PK_BOUND_MS,
           "equal": equal, "winner": want.ravel().tolist(), "entries": PK_DB, "bmma": bmma,
           "ptxas": ptxas}
    print(f"pk_select N={PK_DB} B=1: old {o_ms:.4f} ms, new {n_ms:.4f} ms (the kernel alone, "
          f"operand prepared once: old {ok_ms:.4f}, new {nk_ms:.4f}); speed-up "
          f"{o_ms / n_ms:.2f}x; bound {PK_BOUND_MS} ms, {PK_BOUND_MS / n_ms:.1%} of it "
          f"({PK_BOUND_MS / nk_ms:.1%} as a kernel); the int8 kernel at qg=2, nq=1 "
          f"{pair_ms:.4f} ms; pk_dot {dot_ms:.4f} ms; bit-equal to pk_select_reference "
          f"{equal} {rec['winner']} [{card}]")
    print(f"b1 kernels: SASS BMMA {json.dumps(bmma)}; ptxas {json.dumps(ptxas)}")
    return rec


def old_pk_fractions(lib, q_enc, q_mask, db, prepared: bool):
    """The old B = 1 spectrum: kernel (c)'s int8 kernel with a group of one
    query (qg = 1), its operand laid out by ``_query_tiles`` per call
    (``prepared``: once)."""
    fixed = _query_tiles(q_enc, q_mask, 1) if prepared else None
    n = db[0].shape[0] * db[0].shape[1]
    out = torch.empty((2, 1, n), dtype=torch.int16, device=q_enc.device)

    def run():
        qt = fixed if prepared else _query_tiles(q_enc, q_mask, 1)
        rc = lib.fractions_packed_small_b_launch(1, qt.data_ptr(), db[0].data_ptr(),
                                                 db[1].data_ptr(), n, 1, out.data_ptr(), n,
                                                 torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old pk_fractions launch failed: {rc}")
        return out
    return run


def new_pk_fractions_kernel(q_enc, q_mask, db):
    """The package's pk-fractions kernel alone: its operand laid out once,
    no query check."""
    a = _one_query_operand(q_enc, q_mask)
    n = db[0].shape[0] * db[0].shape[1]
    out = torch.empty((2, 1, n), dtype=torch.int16, device=q_enc.device)
    lib = _build.library()

    def run():
        launch_fractions("pk_fractions", lib, a, *db, n, out, n)
        return out
    return run


def pk_fractions_turns(old, card: str) -> dict:
    """Old against new B = 1 audit spectrum over PK_DB entries, as the
    wrappers run them and as kernels alone, each against
    fractions_packed_small_b_reference; beside them pk_select on the same
    inputs and the int8 kernel at B = 2; ptxas's lines and the SASS BMMA
    count of the b1 kernels."""
    args = pk_inputs(PK_DB, 0, torch.device("cuda"))
    q_enc, q_mask = route_planes(*args[:2])
    db = tuple(x.view(-1, CHUNK, BITS_BYTES) for x in args[2:])
    want = fractions_packed_small_b_reference(q_enc, q_mask, *db)
    runs = {"old": old_pk_fractions(old, q_enc, q_mask, db, False),
            "new": lambda: fractions_packed_small_b(q_enc, q_mask, *db),
            "old_kernel": old_pk_fractions(old, q_enc, q_mask, db, True),
            "new_kernel": new_pk_fractions_kernel(q_enc, q_mask, db)}
    equal = all(torch.equal(f(), want) for f in runs.values())
    del want
    o_ms, n_ms = in_turns(runs["old"], runs["new"])
    ok_ms, nk_ms = in_turns(runs["old_kernel"], runs["new_kernel"])
    q2 = tuple(torch.cat([x, x]) for x in (q_enc, q_mask))
    pair_ms = cuda_ms(lambda: fractions_packed_small_b(*q2, *db))
    select_ms = cuda_ms(lambda: pk_select(*args))
    bmma, ptxas = b1_build_lines()
    rec = {"old_ms": o_ms, "new_ms": n_ms, "old_kernel_ms": ok_ms, "new_kernel_ms": nk_ms,
           "int8_b2_ms": pair_ms, "pk_select_ms": select_ms, "bound_ms": PK_FRACTIONS_BOUND_MS,
           "equal": equal, "entries": PK_DB, "bmma": bmma, "ptxas": ptxas}
    print(f"pk_fractions N={PK_DB} B=1: old {o_ms:.4f} ms, new {n_ms:.4f} ms (the kernel "
          f"alone, operand prepared once: old {ok_ms:.4f}, new {nk_ms:.4f}); speed-up "
          f"{o_ms / n_ms:.2f}x; bound {PK_FRACTIONS_BOUND_MS} ms, "
          f"{PK_FRACTIONS_BOUND_MS / n_ms:.1%} of it ({PK_FRACTIONS_BOUND_MS / nk_ms:.1%} as a "
          f"kernel); the int8 kernel at B=2 {pair_ms:.4f} ms; pk_select {select_ms:.4f} ms; "
          f"bit-equal to fractions_packed_small_b_reference {equal} [{card}]")
    print(f"b1 kernels: SASS BMMA {json.dumps(bmma)}; ptxas {json.dumps(ptxas)}")
    return rec


REQUEST_CODE = r"""
import json, sys, time
import numpy as np, torch
from mpc_iris_tpu_torch.models.engines import PlaintextEngine
from mpc_iris_tpu_torch.parallel import ShardedPlaintextEngine, make_mesh
from mpc_iris_tpu_torch.smoke_data import make_db
n, batches, reps = int(sys.argv[1]), json.loads(sys.argv[2]), int(sys.argv[3])
kind = sys.argv[4]
dev = torch.device("cuda", 0)
pat, msk, _, _, qpat, qmsk = make_db(np.random.default_rng(0), n)
eng = PlaintextEngine(pat, msk, device=dev, storage="packed")
sharded = ShardedPlaintextEngine(pat, msk, make_mesh(4, devices=[dev] * 4))

def wall(fn):
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))

b = max(batches)
if kind == "match":
    res = {f"match B={b}": wall(lambda: eng.match(qpat[:b], qmsk[:b])) for b in batches}
    res["sharded (4, 1) B=1"] = wall(lambda: sharded.match(qpat[:1], qmsk[:1]))
    res["winners"] = [[r.index, r.distance] for r in eng.match(qpat[:b], qmsk[:b])]
else:
    t = float(kind.split("=")[1])
    res = {}
    for b in batches:
        res[f"find_under B={b}"] = wall(lambda: eng.find_under(qpat[:b], qmsk[:b], t))
        res[f"min_fractions B={b}"] = wall(lambda: eng.min_fractions(qpat[:b], qmsk[:b]))
    res["sharded (4, 1) find_under B=1"] = wall(lambda: sharded.find_under(qpat[:1], qmsk[:1], t))
    res["sharded (4, 1) min_fractions B=1"] = wall(lambda: sharded.min_fractions(qpat[:1],
                                                                                qmsk[:1]))
    nd = eng.min_fractions(qpat[:b], qmsk[:b])
    res["winners"] = [[[m.index, m.distance] for m in hits]
                      for hits in eng.find_under(qpat[:b], qmsk[:b], t)]
    res["winners"].append([int(nd[0].astype(np.int64).sum()), int(nd[1].astype(np.int64).sum())])
print("REQUESTS " + json.dumps(res))
"""


def request_times(root: str, kind: str) -> dict:
    """One subprocess with the package under ``root`` first on the path:
    ``kind`` "match": PlaintextEngine.match at REQUEST_BATCHES over PK_DB
    packed entries and the sharded B = 1 request on 4 shards of this card;
    "audit": find_under at AUDIT_T and min_fractions likewise; the median
    host wall of REQUEST_REPS calls each (ms), and the results (winners,
    lists and spectrum sums)."""
    path = os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])
    env = {**os.environ, "PYTHONPATH": path}
    proc = subprocess.run([sys.executable, "-c", REQUEST_CODE, str(PK_DB),
                           json.dumps(REQUEST_BATCHES), str(REQUEST_REPS),
                           kind if kind == "match" else f"audit={AUDIT_T}"], env=env, cwd=root,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"requests under {root} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    line = next(l for l in proc.stdout.splitlines() if l.startswith("REQUESTS "))
    return json.loads(line[len("REQUESTS "):])


def request_turns(old_csrc: str, card: str, kind: str = "match") -> dict:
    """The requests of ``kind`` (request_times) of the old package (the tree
    holding ``old_csrc``) and this one in turns: old, new, new, old; each's
    median of its two turns."""
    old_root = os.path.dirname(os.path.dirname(os.path.abspath(old_csrc)))
    runs = [request_times(r, kind) for r in (old_root, REPO, REPO, old_root)]
    keys = [k for k in runs[0] if k != "winners"]
    rec = {k: {"old_ms": float(np.median([runs[0][k], runs[3][k]])),
               "new_ms": float(np.median([runs[1][k], runs[2][k]]))} for k in keys}
    rec["equal"] = all(r["winners"] == runs[0]["winners"] for r in runs)
    for k in keys:
        print(f"request {k} N={PK_DB}: old {rec[k]['old_ms']:.3f} ms, new "
              f"{rec[k]['new_ms']:.3f} ms (median of {REQUEST_REPS}, host wall; turns "
              f"{[round(r[k], 3) for r in runs]}) [{card}]")
    print(f"requests ({kind}): results equal across the four runs {rec['equal']}")
    return rec


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


def gemm_turns(old, rng, dev, card: str) -> dict:
    """Old against new int8_gemm at M = PRODUCT_ROWS, beside torch._int_mm."""
    res = {}
    db = torch.from_numpy(rng.integers(-128, 128, (CHUNK, BITS), dtype=np.int8)).to(dev)
    for m in PRODUCT_ROWS:
        q = torch.from_numpy(rng.integers(-1, 2, (m, BITS), dtype=np.int8)).to(dev)
        want = torch._int_mm(q, db.T)
        equal = (torch.equal(old_gemm(old, q, db, False)(), want)
                 and torch.equal(int8_gemm(q, db), want))
        o_ms, n_ms = in_turns(old_gemm(old, q, db, False), lambda: int8_gemm(q, db))
        ok_ms, _ = in_turns(old_gemm(old, q, db, True), lambda: int8_gemm(q, db))
        lib_ms = cuda_ms(lambda: torch._int_mm(q, db.T))
        res[m] = {"old_ms": o_ms, "new_ms": n_ms, "old_kernel_ms": ok_ms, "int_mm_ms": lib_ms,
                  "equal": equal}
        print(f"int8_gemm M={m}: old {o_ms:.4f} ms (its kernel alone {ok_ms:.4f}), new "
              f"{n_ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms; bit-equal {equal} [{card}]")
        del want
    return res


def keyed_turns(old, rng, dev, card: str) -> dict:
    """Old against new keyed kernels (serial, pipelined) at B = BATCHES,
    beside kernel (d) alone and (d) + dot_share_batch."""
    res = {}
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
            o_ms, n_ms = in_turns(old_call, new_call)
            ok_ms, nk_ms = in_turns(old_kernel, new_kernel)
            rec[variant] = {"old_ms": o_ms, "new_ms": n_ms, "old_kernel_ms": ok_ms,
                            "new_kernel_ms": nk_ms, "equal": equal}
        rec["d_ms"] = cuda_ms(lambda: share_planes_kernel(kw, 0, 0, CHUNK))
        rec["d_products_ms"] = cuda_ms(
            lambda: dot_share_batch(q, *share_planes_kernel(kw, 0, 0, CHUNK)))
        res[b] = rec
        for variant in ("serial", "pipelined"):
            r = rec[variant]
            print(f"keyed chunk {CHUNK} rows B={b} {variant}: old {r['old_ms']:.4f} ms, new "
                  f"{r['new_ms']:.4f} ms (the kernel alone, operands prepared once: old "
                  f"{r['old_kernel_ms']:.4f}, new {r['new_kernel_ms']:.4f}); bit-equal "
                  f"{r['equal']} [{card}]")
        print(f"keyed chunk {CHUNK} rows B={b}: kernel (d) alone {rec['d_ms']:.4f} ms, (d) + "
              f"products {rec['d_products_ms']:.4f} ms [{card}]")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="the earlier commit's mpc_iris_tpu_torch/csrc")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS),
                    help="the families to compare (default all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    old = build_old(args.old, args.kernels)
    rng = np.random.default_rng(0)
    res = {"card": card, "script": "scripts/probe_kernels_old_vs_new_torch.py"}
    ok = True
    if "gemm" in args.kernels:
        res["gemm"] = gemm_turns(old, rng, dev, card)
        ok &= all(r["equal"] for r in res["gemm"].values())
    if "keyed" in args.kernels:
        res["keyed"] = keyed_turns(old, rng, dev, card)
        ok &= all(r[v]["equal"] for r in res["keyed"].values() for v in ("serial", "pipelined"))
        max_mhz = float(card.split(",")[-1].strip().split()[0])
        res["sass"] = sass_bound(max_mhz,
                                 torch.cuda.get_device_properties(dev).multi_processor_count)
        for what, mix in res["sass"].items():
            print(f"sass {what}: {json.dumps(mix)}")
    if "pk_dot" in args.kernels:
        res["pk_dot"] = pk_dot_turns(old, card)
        ok &= res["pk_dot"]["equal"]
    if "pk_select" in args.kernels:
        res["pk_select"] = pk_select_turns(old, card)
        ok &= res["pk_select"]["equal"]
        res["requests"] = request_turns(args.old, card)
        ok &= res["requests"]["equal"]
    if "pk_fractions" in args.kernels:
        res["pk_fractions"] = pk_fractions_turns(old, card)
        ok &= res["pk_fractions"]["equal"]
        res["audit_requests"] = request_turns(args.old, card, "audit")
        ok &= res["audit_requests"]["equal"]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(f"all outputs bit-equal: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
