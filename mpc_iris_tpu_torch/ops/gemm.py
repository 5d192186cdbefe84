"""Exact int8 products on Hopper's tensor cores (counterpart of the TPU probe
kernels ``scripts/mm_probe.py::make_pallas`` and
``scripts/mm_ktile_probe.py::make_grid_k`` / ``make_slab``).

:func:`int8_gemm` launches the CUDA kernel ``csrc/int8_gemm.cu`` for CUDA
tensors and takes its plain version :func:`int8_gemm_reference` for CPU
tensors. The TPU probes ran int8 and int4 operands; Hopper's ``wgmma`` has
no int4, so int4 values are int8 here (as ``dot_bits_batch_i4`` ->
``dot_bits_batch`` in the port). ``torch._int_mm`` computes the same function
and is the library yardstick beside the kernel; neither function here calls
it. :func:`gemm_plan` picks the kernel's tile and persistent grid.

:func:`wgmma_slabs` lays out the shared-memory (N) operand of the fused keyed
kernel (``ops/keyed_dot.py``), once per call.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mpc_iris_tpu_torch.ops._build import check_launch, library

K_ALIGN = 128                    # the kernel's stage: 128 bytes of K (one swizzle row)
QUERY_TILES = (32, 64, 128, 256)  # query rows per tile (the wgmma N)
DB_TILE = 128                    # DB rows per tile: two consumer warpgroups x 64
H100_SMS = 132
_REFERENCE_ELEMS = 2**27         # float64 elements of the second operand per piece


def int8_gemm_reference(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_gemm`: int32 [M, N] = Q @ DB^T in
    float64 on ``q``'s device, in pieces of DB rows. Exact, whatever the
    order of the sums: every product and partial sum is an integer of
    magnitude at most K x 2^14 (2.1e8 at K = 12,800), far below 2^53."""
    m, n = q.shape[0], db.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=q.device)
    qf = q.to(torch.float64)
    step = max(1, _REFERENCE_ELEMS // max(1, db.shape[1]))
    for n0 in range(0, n, step):
        part = qf @ db[n0:n0 + step].to(torch.float64).T
        out[:, n0:n0 + step] = part.to(torch.int32)
    return out


@dataclass(frozen=True)
class GemmPlan:
    """How :func:`int8_gemm` covers an [M, K] . [N, K]^T product: tiles of
    ``query_rows`` query rows x :data:`DB_TILE` DB rows, query tile fastest,
    walked by ``grid`` persistent blocks (one an SM)."""

    query_rows: int
    query_tiles: int
    db_tiles: int
    grid: int

    @property
    def tiles(self) -> int:
        return self.query_tiles * self.db_tiles

    @property
    def sweeps(self) -> int:
        """Tiles the busiest block takes."""
        return -(-self.tiles // self.grid)


def gemm_plan(m: int, n: int, sms: int = H100_SMS) -> GemmPlan:
    """The kernel's plan for M query rows and N DB rows on ``sms`` SMs: the
    smallest query tile that holds M (so M <= 256 is one tile and every
    block reads DB rows no other block reads), else 256; a persistent grid
    of at most one block an SM."""
    rows = next((t for t in QUERY_TILES if m <= t), QUERY_TILES[-1])
    q_tiles, db_tiles = -(-m // rows), -(-n // DB_TILE)
    return GemmPlan(rows, q_tiles, db_tiles, min(q_tiles * db_tiles, sms))


def wgmma_slabs(q: torch.Tensor, rows: int) -> torch.Tensor:
    """int8 [M, K] -> int8 [G, K/32, rows/8, 2, 8, 16] for G = ceil(M / rows)
    tiles of ``rows`` rows (rows past M zero): per tile and 32-byte K-step,
    the rows x 32-byte slab in the order ``wgmma`` reads it from shared
    memory (K-major, no swizzle, core matrices of 8 rows x 16 bytes: 8-row
    groups, the two 16-byte K halves, 8 rows, 16 bytes), the K-steps
    contiguous."""
    m, k = q.shape
    g = -(-m // rows)
    padded = q.new_zeros((g * rows, k))
    padded[:m] = q
    x = padded.reshape(g, rows // 8, 8, k // 32, 2, 16)  # g, nh, nl, step, kh, kl
    return x.permute(0, 3, 1, 4, 2, 5).contiguous()      # g, step, nh, kh, nl, kl


def int8_gemm(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Exact int8 product: int8 Q [M, K] x int8 DB [N, K] -> int32 [M, N]
    = Q @ DB^T, one launch of ``csrc/int8_gemm.cu`` for CUDA tensors (K a
    multiple of 128, e.g. 12,800); CPU tensors take the plain version."""
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != db.shape[1]:
        raise ValueError("int8_gemm: q [M, K] and db [N, K] must be 2-D with one K")
    if q.dtype != torch.int8 or db.dtype != torch.int8:
        raise TypeError("int8_gemm: q and db must be int8")
    if q.device != db.device:
        raise ValueError("int8_gemm: tensors on different devices")
    if q.device.type == "cpu":
        return int8_gemm_reference(q, db)
    if q.device.type != "cuda":
        raise ValueError(f"int8_gemm: unsupported device {q.device}")
    (m, k), n = q.shape, db.shape[0]
    if not (1 <= m < 2**31 and 1 <= n < 2**31 and k > 0 and k % K_ALIGN == 0):
        raise ValueError(f"int8_gemm: unsupported M={m} N={n} K={k} "
                         f"(K must be a positive multiple of {K_ALIGN})")
    if not db.is_contiguous() or db.data_ptr() % 16:
        raise ValueError("int8_gemm: db must be contiguous and 16-byte aligned")
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = gemm_plan(m, n, sms)
    out = torch.empty((m, n), dtype=torch.int32, device=q.device)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch("int8_gemm", lib.int8_gemm_launch(
            plan.query_rows, plan.grid, q.data_ptr(), db.data_ptr(), m, n, k,
            out.data_ptr(), stream))
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0
