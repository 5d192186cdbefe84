"""Keyed share dots with the DB regenerated inside the product kernel
(counterpart of the TPU probe kernel ``scripts/fused_regen_probe.py::
make_kernel``, serial and ``--interleave``), and the keyed passes that the
fused-regen probe compares (``scripts/fused_mm_regen_probe_torch.py``).

:func:`keyed_share_dots` launches the CUDA kernel ``csrc/keyed_share_dot.cu``
for a query on the card: ChaCha20 on the CUDA cores fused with the two int8
share products on the tensor cores, so no lo/hi plane reaches device memory.
Its ``variant`` is ``"serial"`` (all warps regenerate a stage, then
multiply it) or ``"pipelined"`` (warp-specialized: a producer warpgroup
regenerates the next stage while two consumer warpgroups multiply this one).
A query on the CPU takes the plain version :func:`keyed_share_dots_reference`,
the engines' unfused expression.

The engines keep regeneration and products apart (``KeyedShareEngine``:
kernel (d), then ``dot_share_batch``); nothing here changes their path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mpc_iris_tpu_torch.constants import BITS
from mpc_iris_tpu_torch.ops._build import check_launch, library
from mpc_iris_tpu_torch.ops.chacha import (
    _u32,
    k_permutation,
    share_planes_kernel,
    share_planes_natural,
)
from mpc_iris_tpu_torch.ops.dot import dot_share_batch
from mpc_iris_tpu_torch.ops.gemm import int8_gemm, wgmma_slabs

VARIANTS = ("serial", "pipelined")
# The keyed passes of the fused-regen probe: the engines' path (kernel (d),
# then the products through torch._int_mm), the same with the products
# through int8_gemm, and the fused kernel's two variants.
FAMILIES = ("library", "gemm", "fused-serial", "fused-pipe")
_FUSED = {"fused-serial": "serial", "fused-pipe": "pipelined"}


def keyed_share_dots_reference(q_nat, kw, stream_id, row0, n_rows: int) -> torch.Tensor:
    """Plain version of :func:`keyed_share_dots`: the regenerated planes
    (``share_planes_natural``), then ``dot_share_batch``."""
    return dot_share_batch(q_nat, *share_planes_natural(kw, stream_id, row0, n_rows))


def block_shape(m: int) -> tuple[int, int]:
    """The fused kernel's block for ``m`` query rows: (DB row groups of 64,
    query rows a consumer warpgroup). Up to 128 query rows the two
    warpgroups split 128 DB rows; past that they split 256 query rows over
    64 DB rows, and a batch past 256 rows takes ceil(m / 256) blocks per DB
    tile, each regenerating the tile."""
    if m <= 128:
        return 2, next(t for t in (32, 64, 128) if m <= t)
    return 1, 128


@functools.cache
def _file_order_index(device: torch.device) -> torch.Tensor:
    """Natural -> file K order on ``device``: column k of the file-order
    query is natural column argsort(pi)[k] (:func:`k_permutation`)."""
    return torch.as_tensor(np.argsort(k_permutation()), device=device)


def keyed_share_dots(q_nat: torch.Tensor, kw: torch.Tensor, stream_id, row0, n_rows: int,
                     *, variant: str = "serial") -> torch.Tensor:
    """Share dots of ``q_nat`` against share rows [row0, row0 + n_rows) of
    stream ``stream_id``, regenerated from the key inside the kernel.

    Args:
      q_nat: int8 [M, 12,800] query rows in NATURAL K order
        (``engines._queries_to_natural_k``), values in {-1, 0, 1}.
      kw: int32 [8] key words (``ops.chacha.key_tensor``), on q_nat's device.
      stream_id, row0: the share stream and the chunk's first row, in
        [0, 2^32); the u64 nonce carries past 2^32 inside the chunk.
      n_rows: the chunk's rows.
      variant: "serial" or "pipelined".

    Returns int32 [M, n_rows] in [0, 2^16), bit-equal to
    :func:`keyed_share_dots_reference`.
    """
    if variant not in VARIANTS:
        raise ValueError(f"keyed_share_dots: variant must be one of {VARIANTS}, got {variant!r}")
    if q_nat.dim() != 2 or q_nat.shape[1] != BITS or q_nat.dtype != torch.int8:
        raise ValueError(f"keyed_share_dots: q_nat must be int8 [M, {BITS}]")
    if kw.dtype != torch.int32 or kw.shape != (8,):
        raise ValueError("keyed_share_dots: kw must be an int32 [8] tensor of key words "
                         "(key_tensor)")
    if q_nat.device != kw.device:
        raise ValueError("keyed_share_dots: q_nat and kw on different devices")
    sid, r0, n_rows = _u32(stream_id, "stream id"), _u32(row0, "row offset"), int(n_rows)
    if q_nat.device.type == "cpu":
        return keyed_share_dots_reference(q_nat, kw, sid, r0, n_rows)
    if q_nat.device.type != "cuda":
        raise ValueError(f"keyed_share_dots: unsupported device {q_nat.device}")
    m = q_nat.shape[0]
    if not (1 <= m < 2**31 and 1 <= n_rows < 2**31 - 256):
        raise ValueError(f"keyed_share_dots: unsupported M={m} n_rows={n_rows}")
    wr, qw = block_shape(m)
    q_file = q_nat[:, _file_order_index(q_nat.device)]
    qt = wgmma_slabs(q_file, 2 * qw if wr == 1 else qw)
    corr = 128 * q_nat.sum(dim=1, dtype=torch.int32)
    out = torch.empty((m, n_rows), dtype=torch.int32, device=q_nat.device)
    kw = kw.contiguous()
    lib = library()
    with torch.cuda.device(q_nat.device):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(f"keyed_share_dots[{variant}]", lib.keyed_share_dots_launch(
            int(variant == "pipelined"), wr, qw, qt.data_ptr(), corr.data_ptr(),
            kw.data_ptr(), sid, r0, n_rows, m, out.data_ptr(), stream))
    keyed_share_dots.launches[variant] += 1
    return out


keyed_share_dots.launches = dict.fromkeys(VARIANTS, 0)


def share_dots_gemm(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``dot_share_batch`` with its two products through :func:`int8_gemm`."""
    total = int8_gemm(q, lo)
    corr = 128 * q.sum(dim=1, keepdim=True, dtype=torch.int32)
    total.add_(corr).add_(int8_gemm(q, hi).add_(corr).mul_(256))
    return total.bitwise_and_(0xFFFF)


def share_dots_chunk(family: str, q_nat, kw, stream_id, row0, n_rows: int) -> torch.Tensor:
    """One chunk's keyed share dots, int32 [M, n_rows], through one of
    :data:`FAMILIES`; every family gives the same values."""
    if family in _FUSED:
        return keyed_share_dots(q_nat, kw, stream_id, row0, n_rows, variant=_FUSED[family])
    lo, hi = share_planes_kernel(kw, stream_id, row0, n_rows)
    if family == "library":
        return dot_share_batch(q_nat, lo, hi)
    if family == "gemm":
        return share_dots_gemm(q_nat, lo, hi)
    raise ValueError(f"unknown family {family!r}; expected one of {FAMILIES}")


def keyed_pass_checksum(family: str, q_nat, kw, stream_id, count: int, chunk: int) -> int:
    """A keyed party's whole pass over ``count`` rows in chunks of ``chunk``
    through ``family``: the uint32 sum of every share dot, the value
    ``KeyedShareEngine.fold_pass_fn`` gives for the same query rows. One
    host sync, at the end."""
    acc = torch.zeros((), dtype=torch.int64, device=q_nat.device)
    for r0 in range(0, count, chunk):
        dots = share_dots_chunk(family, q_nat, kw, stream_id, r0, min(chunk, count - r0))
        acc.add_(dots.sum(dtype=torch.int64))
    return int(acc) & 0xFFFFFFFF
