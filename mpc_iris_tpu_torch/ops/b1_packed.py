"""The B = 1 packed-dot probe kernels over the bit-packed DB (counterpart of
the kernel functions of ``scripts/b1_kernel_probe.py``).

:func:`pk_dot` and :func:`pk_select` launch ``pk_dot_kernel`` and
``pk_select_kernel`` (``csrc/b1_packed.cu``, one binary tile loop: the four
AND-popcount products of the query's mask and pattern-and-mask bits
(:func:`pk_dot_operand`) against the DB's, on the ``mma.sync`` b1 tensor
instruction, no unpack) for CUDA tensors; for CPU tensors each takes its
plain version (``*_reference``). Both take the probe's operands as given:
the query pair of :func:`prep_query`, int8 [32, 12,800] with the rows in
``ROT_BITREV`` order (position p holds rotation bitrev5(p), row 31 the
all-zero dummy) and K in the bit-plane-major order of :func:`bitplane_perm`;
the DB as uint8 [N, 1600] pattern and mask planes. Being binary, both take
only a bit-valued query pair (:func:`bit_valued`), as :func:`prep_query`
gives, where the probe's kernels take any int8 rows; they raise on another.

- :func:`pk_dot` gives int32 [32, N] = ``(den << 16) | num`` per (position,
  entry), the probe's ``make_pk_dot`` kernel. Its epilogue is
  :func:`pk_dot_winner`, plain torch as the probe's is XLA outside the
  kernel. It reduces the 31 rotation positions in POSITION order, so on
  equal fractions it keeps the lowest position, not the earliest rotation:
  1/2 at rotation 1 (position 16) against 2/4 at rotation 2 (position 8)
  gives (2, 4). Index and f64 distance are those of :func:`pk_select`; the
  integers may differ.
- :func:`pk_select` gives int32 [3, 1], the winner (n, d, idx) with ties to
  the earliest rotation and then the lowest index: the probe's
  ``make_pk_select``, the products with the exact selection fused into the
  kernel. Its operand takes the rows put back in rotation order
  (``ROT_BITREV`` is an involution), so the row is the rotation. The same
  kernel is kernel (b) for a group of one query:
  ``ops/packed_match.py::match_packed_small_b`` launches it through
  :func:`launch_select`.

The same tile loop's third kernel, ``pk_fractions_kernel``, is kernel (c)
for a group of one query: ``ops/packed_match.py::fractions_packed_small_b``
launches it through :func:`launch_fractions` (the audit spectrum: per entry
the exact rotation minimum (n, d), the earliest rotation's pair on equal
fractions). It has no probe wrapper here; its plain version is
``fractions_packed_small_b_reference``.

The probe's ``tile_n``, ``vmem_mb`` and ``int4`` change neither function (its
selection is exact and index-aware past the first level, and the b1
products are exact), so the wrappers take none of them; the runner
``scripts/b1_kernel_probe_torch.py`` keeps them as flags.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES, N_ROTATIONS
from mpc_iris_tpu_torch.ops._build import check_launch, library
from mpc_iris_tpu_torch.ops.decode import fraction_argmin
from mpc_iris_tpu_torch.ops.dot import dot_bits_batch
from mpc_iris_tpu_torch.ops.scan import prepare_query_planes
from mpc_iris_tpu_torch.ops.select import N_ROT_PAD, ROT_BITREV, select_chunk_reference
from mpc_iris_tpu_torch.utils.profiling import annotate

PLANE = BITS_BYTES        # packed bytes an entry and plane: one K slab of 1,600
_REFERENCE_ENTRIES = 16_384  # DB entries a piece of the plain versions unpack
Q_ROW = PLANE + 32    # the b1 kernels' query row pitch (csrc/b1_packed.cu kQRow)


@functools.cache
def bitplane_perm() -> np.ndarray:
    """K permutation natural -> bit-plane-major: position j = bit * 1600 +
    byte holds natural index byte * 8 + bit (copy of the probe's)."""
    j = np.arange(BITS)
    return (j % PLANE) * 8 + j // PLANE


def prep_query(qpat: torch.Tensor, qmsk: torch.Tensor):
    """Packed query uint8 [1, 1600] x2 -> (qe, qm) int8 [32, 12,800]: the
    rotated encoding and mask, the dummy row appended, the rows in
    ``ROT_BITREV`` order and K bit-plane-major (the probe's ``prep_query``)."""
    q_enc, q_mask = prepare_query_planes(qpat, qmsk)  # [1, 31, K] natural
    perm = torch.as_tensor(bitplane_perm(), device=q_enc.device)
    rev = torch.as_tensor(ROT_BITREV, device=q_enc.device)
    pad = q_enc.new_zeros((1, N_ROT_PAD - N_ROTATIONS, BITS))
    qe = torch.cat([q_enc, pad], dim=1)[0][rev][:, perm]
    qm = torch.cat([q_mask, pad], dim=1)[0][rev][:, perm]
    return qe, qm


def _unpack_bitplane_major(pat: torch.Tensor, msk: torch.Tensor):
    """uint8 [n, 1600] planes -> (enc, mask) int8 [n, 12,800], K
    bit-plane-major: bit-plane b of byte j at b * 1600 + j; enc = m - 2 (p & m)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=pat.device).view(1, 8, 1)
    p = ((pat.unsqueeze(1) >> shifts) & 1).reshape(pat.shape[0], BITS).to(torch.int8)
    m = ((msk.unsqueeze(1) >> shifts) & 1).reshape(msk.shape[0], BITS).to(torch.int8)
    return m - 2 * (p & m), m


def _products(qe, qm, pat, msk):
    """The two int8 products, int32 [32, N] each: dot = qe . enc, den = qm .
    mask, in pieces of DB entries."""
    n = pat.shape[0]
    dot = torch.empty((N_ROT_PAD, n), dtype=torch.int32, device=qe.device)
    den = torch.empty_like(dot)
    for e0 in range(0, n, _REFERENCE_ENTRIES):
        enc, m = _unpack_bitplane_major(pat[e0:e0 + _REFERENCE_ENTRIES],
                                        msk[e0:e0 + _REFERENCE_ENTRIES])
        dot[:, e0:e0 + enc.shape[0]] = dot_bits_batch(qe, enc)
        den[:, e0:e0 + enc.shape[0]] = dot_bits_batch(qm, m)
    return dot, den


def pk_dot_reference(qe, qm, pat, msk) -> torch.Tensor:
    """Plain version of :func:`pk_dot`: unpack the DB bit-plane-major, the
    two int8 products, then ``num | (den << 16)`` with num = (den - dot) >> 1."""
    dot, den = _products(qe, qm, pat, msk)
    return ((den - dot) >> 1) | (den << 16)


def pk_dot_winner(packed: torch.Tensor) -> torch.Tensor:
    """The probe's epilogue of ``make_pk_dot``: int32 [32, N] packed ->
    int32 [3, 1] (n, d, idx). The min over the 31 rotation positions keeps
    the lowest POSITION on equal fractions (see the module docstring), then
    the argmin over entries the lowest index."""
    num = (packed & 0xFFFF)[:N_ROTATIONS]
    den = ((packed >> 16) & 0xFFFF)[:N_ROTATIONS]
    # the index-aware argmin over positions is the probe's
    # fraction_min_rotations (both lexicographic over (fraction, position)),
    # in 5 halving levels instead of 30 folds
    n_r, d_r, _ = fraction_argmin(num, den, axis=0)
    n, d, i = fraction_argmin(n_r, d_r, axis=-1)
    return torch.stack([n, d, i]).reshape(3, 1)


def pk_select_reference(qe, qm, pat, msk) -> torch.Tensor:
    """Plain version of :func:`pk_select`: the two products, then the plain
    selection of ``select_chunk`` (rows back to rotation order, ties to the
    earliest rotation and the lowest index)."""
    dot, den = _products(qe, qm, pat, msk)
    return torch.stack(select_chunk_reference(dot, den, 0))


@functools.cache
def _rot_bitrev_index(device: torch.device) -> torch.Tensor:
    """``ROT_BITREV`` on ``device``, uploaded once: a pageable upload per
    call blocks the host, so the card idles between back-to-back calls."""
    return torch.as_tensor(ROT_BITREV, device=device)


def pack_bitplane_major(bits: torch.Tensor) -> torch.Tensor:
    """0/1 bytes [R, 12,800], K bit-plane-major -> uint8 [R, 1600] packed as
    the DB is: bit b of byte j is K index b * 1600 + j."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device).view(1, 8, 1)
    planes = bits.view(torch.uint8).view(bits.shape[0], 8, PLANE)
    return (planes << shifts).sum(dim=1, dtype=torch.uint8)


def pk_dot_operand(qe: torch.Tensor, qm: torch.Tensor) -> torch.Tensor:
    """(qe, qm) of :func:`prep_query` -> uint8 [64, Q_ROW], the b1 kernels'
    query operand, the layout of their shared memory: row p the mask
    bits of position p, row 32 + p its pattern-and-mask bits (qe = -1),
    packed as the DB is, each row padded by 32 zero bytes. It stands for the
    query only where :func:`bit_valued` holds."""
    bits = torch.cat([qm, (qe < 0).view(torch.int8)])
    return torch.nn.functional.pad(pack_bitplane_major(bits), (0, Q_ROW - PLANE))


def bit_valued(qe: torch.Tensor, qm: torch.Tensor) -> torch.Tensor:
    """Whether the query pair is bit-valued, qm in {0, 1} and qe in {-qm,
    qm}, as :func:`prep_query` gives: a bool tensor on the query's device."""
    q = qe.to(torch.int16)
    return ~((q * q - qm) | (qm >> 1)).any()


def _launch_args(name: str, qe, qm, pat, msk):
    """The argument checks of both kernels. Returns None for CPU tensors
    (the caller takes its plain version), else the kernel library; raises on
    anything the kernels do not take."""
    if (qe.shape != (N_ROT_PAD, BITS) or qm.shape != qe.shape
            or qe.dtype != torch.int8 or qm.dtype != torch.int8):
        raise ValueError(f"{name}: qe/qm must be int8 [{N_ROT_PAD}, {BITS}]")
    if (pat.dim() != 2 or pat.shape[1] != PLANE or msk.shape != pat.shape
            or pat.dtype != torch.uint8 or msk.dtype != torch.uint8):
        raise ValueError(f"{name}: pat/msk must be uint8 [N, {PLANE}] of one shape")
    n = pat.shape[0]
    if not 1 <= n < 2**31:
        raise ValueError(f"{name}: unsupported N={n}")
    if len({t.device for t in (qe, qm, pat, msk)}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if qe.device.type == "cpu":
        return None
    if qe.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qe.device}")
    if not (pat.is_contiguous() and msk.is_contiguous()):
        raise ValueError(f"{name}: pat/msk must be contiguous")
    if pat.data_ptr() % 16 or msk.data_ptr() % 16:
        raise ValueError(f"{name}: pat/msk must be 16-byte aligned (async copies)")
    return library()


def start_query_check(qe: torch.Tensor, qm: torch.Tensor):
    """Start :func:`bit_valued` on the query pair. On the card its result is
    copied to pinned host memory on the current stream, ahead of the kernel
    the caller launches next, with an event after the copy. Returns (flag,
    event or None) for :func:`require_bit_valued`."""
    ok = bit_valued(qe, qm)
    if ok.device.type == "cpu":
        return ok, None
    flag = torch.empty((), dtype=torch.bool, pin_memory=True)
    flag.copy_(ok, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return flag, done


def require_bit_valued(name: str, check) -> None:
    """Wait for a check of :func:`start_query_check` (its event, not the
    kernels launched after it) and raise ValueError if the query is not
    bit-valued."""
    flag, done = check
    if done is not None:
        with annotate("iris.wait"):
            done.synchronize()
    if not bool(flag):
        raise ValueError(f"{name}: the query must be bit-valued (qm in {{0, 1}}, qe in "
                         "{-qm, qm}), as prep_query and prepare_query_planes give")


def pk_dot(qe: torch.Tensor, qm: torch.Tensor, pat: torch.Tensor,
           msk: torch.Tensor) -> torch.Tensor:
    """The probe's pk-dot kernel: int32 [32, N] = (den << 16) | num per
    (query position, DB entry), one launch of ``csrc/b1_packed.cu`` for CUDA
    tensors. The query must be :func:`bit_valued`: the call reads that check
    back after the launch, so it waits for the card (the check is copied out
    ahead of the kernel, so back-to-back calls keep the card busy), and it
    raises ValueError, dropping the output, on a query that fails it."""
    lib = _launch_args("pk_dot", qe, qm, pat, msk)
    if lib is None:
        return pk_dot_reference(qe, qm, pat, msk)
    out = torch.empty((N_ROT_PAD, pat.shape[0]), dtype=torch.int32, device=qe.device)
    with torch.cuda.device(qe.device):
        q = pk_dot_operand(qe, qm)
        check = start_query_check(qe, qm)
        stream = torch.cuda.current_stream().cuda_stream
        check_launch("pk_dot", lib.pk_dot_launch(q.data_ptr(), pat.data_ptr(), msk.data_ptr(),
                                                 pat.shape[0], out.data_ptr(), stream))
    pk_dot.launches += 1
    require_bit_valued("pk_dot", check)
    return out


pk_dot.launches = 0


def launch_select(name: str, lib, q: torch.Tensor, pat: torch.Tensor, msk: torch.Tensor,
                  n_entries: int, out: torch.Tensor, out_stride: int) -> None:
    """One launch of ``pk_select_kernel`` and its fold on the current stream:
    q uint8 [64, Q_ROW], a bit-valued query's operand with the rows in
    rotation order (rows 31 and 63 zero); pat, msk the DB planes, n_entries
    rows of 1600 bytes, checked by the caller; the winner n, d, idx into
    ``out``'s first element and the elements ``out_stride`` and 2 *
    ``out_stride`` int32s after it. Raises if the launch fails."""
    part = torch.empty(3 * -(-n_entries // lib.pk_tile_entries()), dtype=torch.int32,
                       device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    check_launch(name, lib.pk_select_launch(q.data_ptr(), pat.data_ptr(), msk.data_ptr(),
                                            n_entries, part.data_ptr(), out.data_ptr(),
                                            out_stride, stream))


def launch_fractions(name: str, lib, q: torch.Tensor, pat: torch.Tensor, msk: torch.Tensor,
                     n_entries: int, out: torch.Tensor, plane: int) -> None:
    """One launch of ``pk_fractions_kernel`` on the current stream: q, pat,
    msk and n_entries as for :func:`launch_select`; per entry e the exact
    rotation minimum's n into the int16 ``out``'s element e and its d into
    element ``plane`` + e. Counts the launch; raises if it fails."""
    stream = torch.cuda.current_stream().cuda_stream
    check_launch(name, lib.pk_fractions_launch(q.data_ptr(), pat.data_ptr(), msk.data_ptr(),
                                               n_entries, out.data_ptr(), plane, stream))
    launch_fractions.launches += 1


launch_fractions.launches = 0


def pk_select(qe: torch.Tensor, qm: torch.Tensor, pat: torch.Tensor,
              msk: torch.Tensor) -> torch.Tensor:
    """The probe's pk-select kernel: int32 [3, 1], the exact winner (n, d,
    idx) over the DB; for CUDA tensors one launch (and its fold) of
    ``pk_select_kernel`` on the rows put back in rotation order. The query
    must be :func:`bit_valued`, checked as :func:`pk_dot` checks it."""
    lib = _launch_args("pk_select", qe, qm, pat, msk)
    if lib is None:
        return pk_select_reference(qe, qm, pat, msk)
    out = torch.empty((3, 1), dtype=torch.int32, device=qe.device)
    with torch.cuda.device(qe.device):
        rev = _rot_bitrev_index(qe.device)
        q = pk_dot_operand(qe[rev], qm[rev])
        check = start_query_check(qe, qm)
        launch_select("pk_select", lib, q, pat, msk, pat.shape[0], out, 1)
    pk_select.launches += 1
    require_bit_valued("pk_select", check)
    return out


pk_select.launches = 0
