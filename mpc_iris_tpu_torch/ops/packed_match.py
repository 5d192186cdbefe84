"""Small-batch match and audit spectrum directly over the bit-packed DB
(counterpart of ``mpc_iris_tpu/ops/packed_match.py``).

:func:`match_packed_small_b` and :func:`fractions_packed_small_b` launch CUDA
kernels for CUDA tensors; for CPU tensors each takes its plain version
(``*_reference``), a packed scan of ops/scan.py. The kernels never unpack the
DB to memory. Per group of :func:`_launch_plan`:

- groups of 2 and 4 queries run the reference's two int8 products on the
  tensor cores (wgmma, ``csrc/packed_match.cu``, ``csrc/packed_fractions.cu``),
  with the DB operand unpacked in registers from the packed words, one
  bit-plane per K-step of the bit-plane-major K order
  (``csrc/packed_tile.cuh``); the query is laid out per call by
  :func:`_query_tiles` in the order they read it;
- a group of one query (B = 1, and a remainder of one, as at B = 5) takes
  ``csrc/b1_packed.cu``'s binary tile loop: four AND-popcount products of
  packed bits on the binary tensor cores, no unpack, the query as the packed
  operand of :func:`_one_query_operand`; the match's ``pk_select_kernel``
  fuses the exact selection, the spectrum's ``pk_fractions_kernel`` the
  exact rotation minimum per entry. Both are exact only for a bit-valued
  query (q_mask in {0, 1}, q_enc in {-q_mask, q_mask}, as
  ``prepare_query_planes`` gives); the call checks that and raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES, N_ROTATIONS
from mpc_iris_tpu_torch.ops._build import check_launch, library
from mpc_iris_tpu_torch.ops.b1_packed import (
    Q_ROW,
    launch_fractions,
    launch_select,
    require_bit_valued,
    start_query_check,
)
from mpc_iris_tpu_torch.ops.encode import pack_bits
from mpc_iris_tpu_torch.ops.scan import (
    _fractions_scan_packed,
    _match_scan_packed,
    prepare_query_planes,
)
from mpc_iris_tpu_torch.ops.select import N_ROT_PAD
from mpc_iris_tpu_torch.utils.profiling import annotate

# Dispatch boundary of the packed small-batch kernel. It keeps the reference's
# 1..8 so both packages route the same batches; the reference's value is a TPU
# compiler limit, so the H100 boundary is to be re-decided from measurements
# of this kernel against the scan path (ops/select.py) in a later change.
SMALL_B_MAX = 8

SLAB = 32  # K per tensor-core step: 32 packed bytes of one bit-plane


def small_b_ok(b: int) -> bool:
    """True when the packed small-batch kernel takes a batch of ``b``."""
    return 1 <= b <= SMALL_B_MAX


def match_packed_small_b_reference(q_enc, q_mask, db_pat, db_msk) -> torch.Tensor:
    """Plain version of :func:`match_packed_small_b`: the packed scan with
    the plain selection (per chunk unpack and encode the DB, two int8
    products, the exact chunk selection, and a running min over chunks)."""
    return _match_scan_packed(q_enc, q_mask, db_pat, db_msk, fused=False)


@functools.cache
def _bitplane_perm() -> np.ndarray:
    """K permutation natural -> bit-plane-major: position j = bit * 1600 +
    byte holds natural index byte * 8 + bit (copy of
    ``mpc_iris_tpu.ops.packed_match._bitplane_perm``). In this order one
    bit-plane of the packed DB is one contiguous K slab."""
    j = np.arange(BITS)
    return (j % BITS_BYTES) * 8 + j // BITS_BYTES


@functools.cache
def _bitplane_index(device: torch.device) -> torch.Tensor:
    """:func:`_bitplane_perm` on ``device``, uploaded once: a pageable upload
    per call would block the host on every request."""
    return torch.as_tensor(_bitplane_perm(), device=device)


def _launch_plan(b: int) -> list[tuple[int, int, int]]:
    """The kernel launches for a batch of ``b``: (first query, queries, group
    size). Groups of 4 queries (N = 128 rotation rows); a remainder of 1 or 2
    gets its own group size, one of 3 a group of 4 with a zero query. A group
    of 1 takes a binary kernel (module docstring)."""
    plan = [(0, b - b % 4, 4)] if b >= 4 else []
    r = b % 4
    if r:
        plan.append((b - r, r, {1: 1, 2: 2, 3: 4}[r]))
    return plan


def _query_tiles(q_enc: torch.Tensor, q_mask: torch.Tensor, qg: int) -> torch.Tensor:
    """int8 [B, 31, K] prepared query planes -> the kernels' query operand,
    int8 [G, 50, 8, 2, N/8, 2, 8, 16] for G = ceil(B / qg) groups of N =
    32 * qg rotation rows (row 31 of each query and the padding queries all
    zero: mask 0, never valid).

    Axes: group; the K-step (byte slab jj, bit-plane b), in the order the
    kernel takes them; encoding, then mask; and the N x 32-byte slab of K =
    b * 1600 + jj * 32 + (0..31) in the bit-plane-major order of
    :func:`_bitplane_perm`, as wgmma reads it from shared memory (K-major, no
    swizzle): 8-row groups, the two 16-byte K halves, 8 rows, 16 bytes."""
    b = q_enc.shape[0]
    g = -(-b // qg)
    n = 32 * qg
    perm = _bitplane_index(q_enc.device)

    def operand(q):
        rows = q.new_zeros((g * qg, N_ROT_PAD, BITS))
        rows[:b, :N_ROTATIONS] = q
        x = rows.reshape(g, n, BITS)[:, :, perm]
        x = x.reshape(g, n // 8, 8, 8, BITS_BYTES // SLAB, 2, 16)  # g, nh, nl, bit, jj, kh, kl
        return x.permute(0, 4, 3, 1, 5, 2, 6)                     # g, jj, bit, nh, kh, nl, kl

    return torch.stack([operand(q_enc), operand(q_mask)], dim=3).contiguous()


def _one_query_operand(q_enc: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
    """int8 [1, 31, K] prepared query planes (natural K order) -> uint8 [64,
    Q_ROW], the query operand of ``pk_select_kernel`` and
    ``pk_fractions_kernel`` with the rows in rotation order: row r the mask
    bits of rotation r, row 32 + r its pattern-and-mask bits (q_enc = -1),
    rows 31 and 63 zero (the dummy: den 0, never valid), each packed
    LSB-first as the DB is (``pack_bits``: bit b of byte j is K index 8 j +
    b) and padded with zeros to Q_ROW bytes.
    It stands for the query only where it is bit-valued."""
    bits = q_mask.new_zeros((2, N_ROT_PAD, BITS))
    bits[0, :N_ROTATIONS] = q_mask[0]
    bits[1, :N_ROTATIONS] = q_enc[0] < 0
    packed = pack_bits(bits.view(2 * N_ROT_PAD, BITS))
    return torch.nn.functional.pad(packed, (0, Q_ROW - BITS_BYTES))


def _launch_args(name: str, q_enc, q_mask, db_pat, db_msk):
    """The argument checks of both packed small-batch kernels. Returns None
    for CPU tensors (the caller takes its plain version), else the kernel
    library and the DB entry count; raises on anything the kernels do not
    take."""
    b = q_enc.shape[0]
    if (q_enc.shape != (b, N_ROTATIONS, BITS) or q_mask.shape != q_enc.shape
            or q_enc.dtype != torch.int8 or q_mask.dtype != torch.int8):
        raise ValueError(f"{name}: q_enc/q_mask must be int8 [B, {N_ROTATIONS}, {BITS}]")
    if (db_pat.dim() != 3 or db_pat.shape[2] != BITS_BYTES
            or db_msk.shape != db_pat.shape
            or db_pat.dtype != torch.uint8 or db_msk.dtype != torch.uint8):
        raise ValueError(f"{name}: db planes must be uint8 [C, c, {BITS_BYTES}] of one shape")
    if len({t.device for t in (q_enc, q_mask, db_pat, db_msk)}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if q_enc.device.type == "cpu":
        return None
    if q_enc.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q_enc.device}")
    if not (db_pat.is_contiguous() and db_msk.is_contiguous()):
        raise ValueError(f"{name}: db planes must be contiguous")
    if db_pat.data_ptr() % 16 or db_msk.data_ptr() % 16:
        raise ValueError(f"{name}: db planes must be 16-byte aligned (bulk async copies)")
    n_entries = db_pat.shape[0] * db_pat.shape[1]
    # the grid is one block per (entry tile of >= 128, query group)
    if not (1 <= b and 1 <= n_entries < 2**31 and -(-n_entries // 128) * b < 2**31):
        raise ValueError(f"{name}: unsupported B={b} N={n_entries}")
    return library(), n_entries


def match_packed_small_b(q_enc: torch.Tensor, q_mask: torch.Tensor,
                         db_pat: torch.Tensor, db_msk: torch.Tensor) -> torch.Tensor:
    """Small-batch match over a bit-packed DB: one kernel launch (and its
    fold) per query group size of :func:`_launch_plan`.

    Args:
      q_enc, q_mask: int8 [B, 31, K] prepared query planes
        (``engines.prepare_query_planes``): q_enc is the ring encoding under
        q_mask ({-1, 0, 1}, nonzero exactly where q_mask is 1).
      db_pat, db_msk: uint8 [C, c, 1600] packed chunks; padded entries must
        be all zero (mask 0 -> den 0 -> never a valid distance).

    Returns int32 [3, B]: (numerator, denominator, global DB index) of each
    query's exact rational argmin over the whole DB, ties to the earliest
    rotation and then the lowest index.

    A group of one query launches the binary kernel, which needs a
    bit-valued query: its check is copied out ahead of the kernel and read
    after the launches, so such a call waits for the check (not for the
    kernels) and raises ValueError on a query that fails it.
    """
    launch = _launch_args("match_packed_small_b", q_enc, q_mask, db_pat, db_msk)
    if launch is None:
        return match_packed_small_b_reference(q_enc, q_mask, db_pat, db_msk)
    lib, n_entries = launch
    b = q_enc.shape[0]
    out = torch.empty((3, b), dtype=torch.int32, device=q_enc.device)
    checks = []
    with torch.cuda.device(q_enc.device):
        for q0, nq, qg in _launch_plan(b):
            qe, qm = q_enc[q0:q0 + nq], q_mask[q0:q0 + nq]
            if qg == 1:
                with annotate("iris.query_prep"):
                    q = _one_query_operand(qe, qm)
                    checks.append(start_query_check(qe, qm))
                launch_select("match_packed_small_b", lib, q, db_pat, db_msk, n_entries,
                              out[:, q0:], b)
            else:
                _launch_int8_group(lib, qe, qm, db_pat, db_msk, n_entries, qg, out[:, q0:], b)
            match_packed_small_b.launches += 1
    for check in checks:
        require_bit_valued("match_packed_small_b", check)
    return out


match_packed_small_b.launches = 0


def _launch_int8_group(lib, q_enc, q_mask, db_pat, db_msk, n_entries: int, qg: int,
                       out: torch.Tensor, out_stride: int) -> None:
    """One launch (and its fold) of the int8 match kernel
    (``csrc/packed_match.cu``) on the current stream for the queries in
    groups of ``qg`` (2 or 4; the last group padded by zero queries), the
    winners into ``out``'s first columns, rows ``out_stride`` apart."""
    nq = q_enc.shape[0]
    with annotate("iris.query_prep"):
        qt = _query_tiles(q_enc, q_mask, qg)
    n_tiles = -(-n_entries // lib.packed_tile_entries(qg))
    part = torch.empty(3 * nq * n_tiles, dtype=torch.int32, device=q_enc.device)
    check_launch("match_packed_small_b", lib.match_packed_small_b_launch(
        qg, qt.data_ptr(), db_pat.data_ptr(), db_msk.data_ptr(), n_entries, nq,
        part.data_ptr(), out.data_ptr(), out_stride, torch.cuda.current_stream().cuda_stream))


def match_packed_int8_pairs(q_enc: torch.Tensor, q_mask: torch.Tensor,
                            db_pat: torch.Tensor, db_msk: torch.Tensor) -> torch.Tensor:
    """Every query through the int8 match kernel in groups of 2, the last
    padded by a zero query: at B = 1 a group of 2 with one query (nq = 1),
    the int8 design that groups of one query ran before the binary kernel
    took them. Kept for comparison (chip_smoke.py, tests/test_torch_gpu.py);
    no request takes it and it counts no launch. Arguments and result as
    for :func:`match_packed_small_b`, and its plain version for CPU
    tensors."""
    launch = _launch_args("match_packed_int8_pairs", q_enc, q_mask, db_pat, db_msk)
    if launch is None:
        return match_packed_small_b_reference(q_enc, q_mask, db_pat, db_msk)
    lib, n_entries = launch
    b = q_enc.shape[0]
    out = torch.empty((3, b), dtype=torch.int32, device=q_enc.device)
    with torch.cuda.device(q_enc.device):
        _launch_int8_group(lib, q_enc, q_mask, db_pat, db_msk, n_entries, 2, out, b)
    return out


def planted_packed_case(rng: np.random.Generator, n: int = 700, b: int = 3):
    """Packed DB uint8 [n, 1600] x2 and query planes [b, 1600] x2, with
    planted traps: sparse masks past row 257 (den of a few bits, so equal
    fractions as different pairs across rotations are common), exact
    duplicates at rows congruent mod 128 (129 and 257) that are query 0's
    exact self-match, an all-invalid entry (7), and a query sharing no valid
    bit with the DB (2)."""
    pat = rng.integers(0, 256, size=(n, BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, size=(n, BITS_BYTES), dtype=np.uint8)
    sparse = np.zeros((n, BITS), dtype=np.uint8)
    rows = rng.integers(258, n, size=n // 2)
    sparse[rows[:, None], rng.integers(0, BITS, size=(rows.size, 6))] = 1
    msk[rows] = np.packbits(sparse[rows], axis=1, bitorder="little")
    pat[257], msk[257] = pat[129], msk[129]
    msk[7] = 0
    qpat = pat[rng.integers(0, n, size=b)].copy()
    qmsk = msk[rng.integers(0, n, size=b)].copy()
    qpat[0], qmsk[0] = pat[129], msk[129]
    if b > 2:
        qmsk[2] = 0
    return pat, msk, qpat, qmsk


def fractions_packed_small_b_reference(q_enc, q_mask, db_pat, db_msk) -> torch.Tensor:
    """Plain version of :func:`fractions_packed_small_b`: the packed
    spectrum scan (per chunk unpack and encode the DB, two int8 products,
    the exact rotation min)."""
    return _fractions_scan_packed(q_enc, q_mask, db_pat, db_msk)


def fractions_packed_small_b(q_enc: torch.Tensor, q_mask: torch.Tensor,
                             db_pat: torch.Tensor, db_msk: torch.Tensor) -> torch.Tensor:
    """Small-batch audit spectrum over a bit-packed DB: one kernel launch per
    query group size of :func:`_launch_plan`.

    Arguments as for :func:`match_packed_small_b`. Returns int16
    [2, B, C*c]: per (query, entry) the min-over-31-rotations exact
    (numerator, denominator), the earliest rotation's pair on equal
    fractions; padded entries report (0, 0). The values are the reference's
    uint16 spectrum (all at most 12,800); callers trim to the true count.

    A group of one query launches the binary kernel and is checked as in
    :func:`match_packed_small_b`: the call waits for the check and raises
    ValueError on a query that is not bit-valued.
    """
    launch = _launch_args("fractions_packed_small_b", q_enc, q_mask, db_pat, db_msk)
    if launch is None:
        return fractions_packed_small_b_reference(q_enc, q_mask, db_pat, db_msk)
    lib, n_entries = launch
    b = q_enc.shape[0]
    out = torch.empty((2, b, n_entries), dtype=torch.int16, device=q_enc.device)
    checks = []
    with torch.cuda.device(q_enc.device):
        stream = torch.cuda.current_stream().cuda_stream
        for q0, nq, qg in _launch_plan(b):
            qe, qm = q_enc[q0:q0 + nq], q_mask[q0:q0 + nq]
            if qg == 1:
                with annotate("iris.query_prep"):
                    q = _one_query_operand(qe, qm)
                    checks.append(start_query_check(qe, qm))
                launch_fractions("fractions_packed_small_b", lib, q, db_pat, db_msk, n_entries,
                                 out[0, q0], b * n_entries)
            else:
                with annotate("iris.query_prep"):
                    qt = _query_tiles(qe, qm, qg)
                check_launch("fractions_packed_small_b", lib.fractions_packed_small_b_launch(
                    qg, qt.data_ptr(), db_pat.data_ptr(), db_msk.data_ptr(), n_entries, nq,
                    out[0, q0].data_ptr(), b * n_entries, stream))
            fractions_packed_small_b.launches += 1
    for check in checks:
        require_bit_valued("fractions_packed_small_b", check)
    return out


fractions_packed_small_b.launches = 0


def _canary_inputs(device, pat, msk, qpat, qmsk):
    """The canaries' tensors: query planes, and the 700-entry DB as 3 chunks
    of 304, the last padded with all-zero entries (a ragged 64-entry tile
    edge)."""
    q_enc, q_mask = prepare_query_planes(torch.from_numpy(qpat).to(device),
                                         torch.from_numpy(qmsk).to(device))
    db_pat, db_msk = (torch.from_numpy(np.pad(x, ((0, 3 * 304 - 700), (0, 0))))
                      .reshape(3, 304, BITS_BYTES).to(device) for x in (pat, msk))
    return q_enc, q_mask, db_pat, db_msk


def check_match_packed_small_b(device) -> None:
    """Kernel canary: both CUDA kernels (B = 3, a group of 4 with a zero
    query; B = 1, the binary kernel) equal the plain version, bit for bit,
    on planted ties, a ragged tile edge and a padded tail chunk."""
    rng = np.random.default_rng(0xB17)
    pat, msk, qpat, qmsk = planted_packed_case(rng)  # 700 entries
    q_enc, q_mask, db_pat, db_msk = _canary_inputs(device, pat, msk, qpat, qmsk)
    for b in (3, 1):
        args = (q_enc[:b], q_mask[:b], db_pat, db_msk)
        got = match_packed_small_b(*args).cpu()
        want = match_packed_small_b_reference(*args).cpu()
        if not torch.equal(got, want) or int(got[2, 0]) != 129:
            raise RuntimeError(f"match_packed_small_b kernel self-test FAILED on "
                               f"{device} at B={b}: {got.tolist()} != {want.tolist()}")


def check_fractions_packed_small_b(device) -> None:
    """Kernel canary: both audit-spectrum kernels (B = 3, a group of 4 with a
    zero query; B = 1, the binary kernel) equal the plain version, bit for
    bit, on the same planted traps; the self-match at 129 and its duplicate
    at 257 report (0, d), the all-invalid entry 7 and the padded tail (0,
    0)."""
    rng = np.random.default_rng(0xF4AC)
    pat, msk, qpat, qmsk = planted_packed_case(rng)  # 700 entries
    q_enc, q_mask, db_pat, db_msk = _canary_inputs(device, pat, msk, qpat, qmsk)
    for b in (3, 1):
        args = (q_enc[:b], q_mask[:b], db_pat, db_msk)
        got = fractions_packed_small_b(*args).cpu()
        want = fractions_packed_small_b_reference(*args).cpu()
        if (not torch.equal(got, want) or got[0, 0, 129] != 0 or got[0, 0, 257] != 0
                or got[1, :, 7].any() or got[:, :, 700:].any()):
            raise RuntimeError(f"fractions_packed_small_b kernel self-test FAILED on {device} "
                               f"at B={b}")
