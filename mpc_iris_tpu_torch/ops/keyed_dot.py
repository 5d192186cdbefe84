"""Keyed share dots with the DB regenerated inside the product kernel
(counterpart of the TPU probe kernel ``scripts/fused_regen_probe.py::
make_kernel``, serial and ``--interleave``), and the keyed passes that the
fused-regen probe compares (``scripts/fused_mm_regen_probe_torch.py``).

:func:`keyed_share_dots` launches the CUDA kernel ``csrc/keyed_share_dot.cu``
for a query on the card: ChaCha20 on the CUDA cores fused with the two int8
share products on the tensor cores, so no lo/hi plane reaches device memory.
Its ``variant`` is ``"serial"`` (a block regenerates a stage straight into
``wgmma``'s operand layout, then multiplies it; co-resident blocks overlap
the two: :func:`serial_shape`) or ``"pipelined"`` (warp-specialized: a
producer warpgroup regenerates the next stage while two consumer warpgroups
multiply this one: :func:`block_shape`).
A query on the CPU takes the plain version :func:`keyed_share_dots_reference`,
the engines' unfused expression.

The engines keep regeneration and products apart (``KeyedShareEngine``:
kernel (d), then ``dot_share_batch``); nothing here changes their path.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

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
    """The pipelined kernel's block for ``m`` query rows: (DB row groups of
    64, query rows a consumer warpgroup). Up to 128 query rows the two
    warpgroups split 128 DB rows; past that they split 256 query rows over
    64 DB rows, and a batch past 256 rows takes ceil(m / 256) blocks per DB
    tile, each regenerating the tile."""
    if m <= 128:
        return 2, next(t for t in (32, 64, 128) if m <= t)
    return 1, 128


SERIAL_DB_ROWS = 32        # DB rows a serial block: lo and hi are the wgmma's 64 M rows
SERIAL_THREADS = 128       # one warpgroup
REGISTERS_PER_SM = 65_536  # 32-bit registers of an H100 SM


@dataclass(frozen=True)
class SerialShape:
    """The serial kernel's block for a batch: one warpgroup, 32 DB rows
    against ``query_rows`` query rows (the wgmma N); each thread makes
    ``per_thread`` ChaCha blocks a stage (two: interleaved); ``buffers``
    query slab buffers (two: the next stage's copy in flight)."""

    query_rows: int
    per_thread: int
    buffers: int

    @property
    def launch_args(self) -> tuple[int, int, int]:
        return self.query_rows, self.per_thread, self.buffers

    @property
    def steps(self) -> int:
        """ChaCha blocks (K-steps) a stage."""
        return self.per_thread * SERIAL_THREADS // SERIAL_DB_ROWS

    @property
    def accumulators(self) -> int:
        """int32 accumulator registers a thread: lo and hi of 32 DB rows
        against ``query_rows`` queries, over 128 threads."""
        return 2 * SERIAL_DB_ROWS * self.query_rows // SERIAL_THREADS

    @property
    def smem(self) -> int:
        """Shared memory a block: a stage of lo and hi rows, the query slab
        buffers, their mbarriers."""
        stage = self.steps * 32
        return stage * 2 * SERIAL_DB_ROWS + self.buffers * (stage * self.query_rows + 8)

    @property
    def blocks_per_sm(self) -> int:
        """The blocks an SM ``__launch_bounds__`` asks for, from the
        registers a thread needs: the accumulators and the ChaCha state
        (about 48, 72 with two blocks interleaved)."""
        state = 72 if self.per_thread == 2 else 48
        return REGISTERS_PER_SM // (SERIAL_THREADS * (self.accumulators + state))


def serial_shape(m: int) -> SerialShape:
    """The serial kernel's block for ``m`` query rows: the smallest query
    tile that holds them (32, 64, 128; else 256, and a batch past 256 rows
    takes several blocks per DB tile, each regenerating the tile). At 256
    each thread makes two blocks a stage, interleaved; below it one, with the
    next stage's query slabs copied a stage ahead (faster at B = 1 on an H100,
    PERF.md)."""
    rows = next((t for t in (32, 64, 128) if m <= t), 256)
    return SerialShape(rows, 2, 1) if rows == 256 else SerialShape(rows, 1, 2)


def serial_grid(m: int, n_rows: int) -> int:
    """Blocks of a serial launch: one per 32-row DB tile and query tile."""
    return -(-n_rows // SERIAL_DB_ROWS) * -(-m // serial_shape(m).query_rows)


@functools.cache
def _file_order_index(device: torch.device) -> torch.Tensor:
    """Natural -> file K order on ``device``: column k of the file-order
    query is natural column argsort(pi)[k] (:func:`k_permutation`)."""
    return torch.as_tensor(np.argsort(k_permutation()), device=device)


@functools.cache
def _slab_index(rows: int, device: torch.device) -> torch.Tensor:
    """Flat offsets into a natural-order tile of ``rows`` query rows, in the
    order of :func:`wgmma_slabs` of its file-order columns: one gather lays
    a tile out for the kernels."""
    nat = torch.arange(rows * BITS).reshape(rows, BITS)
    file_order = nat[:, _file_order_index(torch.device("cpu"))]
    return wgmma_slabs(file_order, rows).reshape(-1).to(device)


def query_slabs(q_nat: torch.Tensor, rows: int) -> torch.Tensor:
    """``wgmma_slabs`` of ``q_nat``'s columns in file order, tiles of
    ``rows`` rows (rows past M zero), by one pad and one gather."""
    m = q_nat.shape[0]
    g = -(-m // rows)
    padded = torch.nn.functional.pad(q_nat, (0, 0, 0, g * rows - m))
    return padded.view(g, rows * BITS)[:, _slab_index(rows, q_nat.device)]


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
    sid, r0, n_rows = _check(q_nat, kw, stream_id, row0, n_rows, variant)
    if q_nat.device.type == "cpu":
        return keyed_share_dots_reference(q_nat, kw, sid, r0, n_rows)
    return _FusedQuery.of(q_nat, variant).launch(kw, sid, r0, n_rows)


keyed_share_dots.launches = dict.fromkeys(VARIANTS, 0)


def _check(q_nat, kw, stream_id, row0, n_rows, variant: str) -> tuple[int, int, int]:
    """Raises on what :func:`keyed_share_dots` does not take; returns the
    stream id, row offset and row count as ints."""
    if variant not in VARIANTS:
        raise ValueError(f"keyed_share_dots: variant must be one of {VARIANTS}, got {variant!r}")
    if q_nat.dim() != 2 or q_nat.shape[1] != BITS or q_nat.dtype != torch.int8:
        raise ValueError(f"keyed_share_dots: q_nat must be int8 [M, {BITS}]")
    if kw.dtype != torch.int32 or kw.shape != (8,):
        raise ValueError("keyed_share_dots: kw must be an int32 [8] tensor of key words "
                         "(key_tensor)")
    if q_nat.device != kw.device:
        raise ValueError("keyed_share_dots: q_nat and kw on different devices")
    if q_nat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"keyed_share_dots: unsupported device {q_nat.device}")
    return _u32(stream_id, "stream id"), _u32(row0, "row offset"), int(n_rows)


@dataclass(frozen=True)
class _FusedQuery:
    """A query on the card laid out once for one fused kernel: its slabs,
    its correction (128 x each row's sum) and the kernel's block shape; a
    keyed pass launches it for every chunk."""

    variant: str
    qt: torch.Tensor
    corr: torch.Tensor
    args: tuple

    @classmethod
    def of(cls, q_nat: torch.Tensor, variant: str) -> "_FusedQuery":
        m = q_nat.shape[0]
        if variant == "serial":
            shape = serial_shape(m)
            rows, args = shape.query_rows, shape.launch_args
        else:
            wr, qw = block_shape(m)
            rows, args = (2 * qw if wr == 1 else qw), (wr, qw)
        return cls(variant, query_slabs(q_nat, rows), 128 * q_nat.sum(dim=1, dtype=torch.int32),
                   args)

    def launch(self, kw: torch.Tensor, sid: int, r0: int, n_rows: int) -> torch.Tensor:
        m = self.corr.shape[0]
        if not (1 <= m < 2**31 and 1 <= n_rows < 2**31 - 256):
            raise ValueError(f"keyed_share_dots: unsupported M={m} n_rows={n_rows}")
        out = torch.empty((m, n_rows), dtype=torch.int32, device=self.corr.device)
        lib = library()
        launch = (lib.keyed_share_dots_serial_launch if self.variant == "serial"
                  else lib.keyed_share_dots_pipe_launch)
        kw = kw.contiguous()
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream().cuda_stream
            check_launch(f"keyed_share_dots[{self.variant}]", launch(
                *self.args, self.qt.data_ptr(), self.corr.data_ptr(), kw.data_ptr(), sid, r0,
                n_rows, m, out.data_ptr(), stream))
        keyed_share_dots.launches[self.variant] += 1
        return out


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
    host sync, at the end. On the card a fused family lays the query out
    once for the whole pass."""
    acc = torch.zeros((), dtype=torch.int64, device=q_nat.device)
    fused = None  # on the card the fused kernels' query is laid out once a pass
    if family in _FUSED and q_nat.device.type == "cuda":
        sid = _check(q_nat, kw, stream_id, 0, chunk, _FUSED[family])[0]
        fused = _FusedQuery.of(q_nat, _FUSED[family])
    for r0 in range(0, count, chunk):
        n = min(chunk, count - r0)
        dots = (fused.launch(kw, sid, r0, n) if fused
                else share_dots_chunk(family, q_nat, kw, stream_id, r0, n))
        acc.add_(dots.sum(dtype=torch.int64))
    return int(acc) & 0xFFFFFFFF
