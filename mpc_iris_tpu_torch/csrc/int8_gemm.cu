// Exact int8 product C[M, N] = Q[M, K] . DB[N, K]^T with int32 sums, on
// Hopper's int8 tensor cores (wgmma), for K a multiple of 128.
//
// Replaces the TPU probe kernels scripts/mm_probe.py::make_pallas (whole-K
// in-kernel matmul, int8 and int4 operands), scripts/mm_ktile_probe.py::
// make_grid_k (K as a revisited-accumulator grid axis) and ::make_slab (a
// static K-slab loop inside the kernel). The three compute one function, so
// they are one kernel here: blocks run in no order, so a K loop inside the
// block takes the sequential grid axis's place, and Hopper's wgmma has no
// int4, so int4 operands are int8 (as dot_bits_batch_i4 -> dot_bits_batch).
//
// What bounds it on the H100: at [4,096 x 12,800] . [16,384 x 12,800] (the
// scan's products of a B = 128 request) the 1.72e12 int8 operations take
// 0.868 ms at 1,979 TOPS, against 0.16 ms to move its 530 MB once:
// operations. At M = 31 and 248 (the keyed pass at B = 1 and 8) the 210 MB
// DB read bounds it (0.063-0.068 ms). Design (warp-specialized, persistent):
// - Both operands by TMA straight from the row-major int8 tensors, with
//   128-byte swizzle: one stage is 128 bytes of K of a tile's 128 DB rows
//   and BQ query rows; rows past the tensors' ends arrive as zeros.
// - One producer thread keeps a ring of stages full (full and empty
//   mbarriers per stage); two consumer warpgroups run SS-mode wgmma (both
//   operands from shared memory, no fragment loads), 64 DB rows each
//   (the wgmma M side) against the tile's BQ query rows (its N side:
//   32, 64, 128 or 256), and release a stage once the next stage's group is
//   issued (wgmma_wait<1>): one group stays in flight. setmaxnreg moves
//   registers from the producer warpgroup to the consumers (128 int32
//   accumulators a thread at BQ = 256).
// - Persistent: one block per SM walks tiles t = blockIdx.x, + gridDim.x,
//   query tile fastest, so the blocks in flight share DB tiles and query
//   tiles in L2; the producer fills the next tile's stages while the
//   consumers store this tile's accumulators (streaming 4-byte stores, each
//   warp instruction four full 32-byte segments).
// - M <= 256 is one query tile: every block reads all query rows and one
//   DB tile, so DB is read once; the wrapper's plan (ops/gemm.py::gemm_plan)
//   picks BQ and the grid.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_tile.cuh"
#include "tensor_map.cuh"

namespace mpc_iris {
namespace {

constexpr int kConsumers = 2;                      // warpgroups running wgmma
constexpr int kThreads = (kConsumers + 1) * 128;   // and one producer warpgroup
constexpr int kDbRows = kConsumers * 64;           // DB rows per tile
constexpr int kKBytes = 128;                       // K bytes per stage (one swizzle row)
constexpr int kRingBytes = 192 * 1024;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// BQ: query rows per tile, the wgmma N.
template <int BQ>
struct GemmCfg {
  static constexpr int kDbBytes = kDbRows * kKBytes;
  static constexpr int kQBytes = BQ * kKBytes;
  static constexpr int kStage = kDbBytes + kQBytes;
  static constexpr int kStages = kRingBytes / kStage < 8 ? kRingBytes / kStage : 8;
  static constexpr int kBarOffset = kStages * kStage;
  // 1,024 bytes of slack: the swizzled tiles need 1,024-byte alignment
  static constexpr int kSmem = 1024 + kBarOffset + 2 * kStages * 8;
  static_assert(kStage % 1024 == 0 && kStages >= 4, "ring of 1,024-byte-aligned stages");
};

// grid: persistent blocks; tile t covers query rows [qt*BQ, +BQ) and DB rows
// [dt*kDbRows, +kDbRows) for qt = t % n_qt, dt = t / n_qt. c: int32 [m][n].
template <int BQ>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap db_map, int m, int n, int k, int n_qt,
                 int tiles, int* __restrict__ c) {
  using C = GemmCfg<BQ>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (tile::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + C::kBarOffset;
  const uint32_t empty = full + 8 * C::kStages;
  const int n_st = k / kKBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      tile::mbar_init(full + 8 * s, 1);                 // the producer's expect_tx
      tile::mbar_init(empty + 8 * s, kConsumers * 4);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy
    tile::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&q_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&db_map))
                   : "memory");
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int q0 = (t % n_qt) * BQ;
        const int d0 = (t / n_qt) * kDbRows;
        for (int st = 0; st < n_st; ++st, ++it) {
          const int slot = it % C::kStages;
          tile::mbar_wait(empty + 8 * slot, ((it / C::kStages) & 1) ^ 1);
          const uint32_t base = ring + slot * C::kStage;
          tile::mbar_expect_tx(full + 8 * slot, C::kStage);
          tile::tma_load_2d(base, &db_map, st * kKBytes, d0, full + 8 * slot);
          tile::tma_load_2d(base + C::kDbBytes, &q_map, st * kKBytes, q0, full + 8 * slot);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 DB rows each against the tile's BQ query rows
  tile::regs_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row = wg * 64 + (threadIdx.x / 32) % 4 * 16 + g;  // DB row of the tile, + 8h
  int acc[BQ / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int q0 = (t % n_qt) * BQ;
    const int d0 = (t / n_qt) * kDbRows;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      acc[i] = 0;
      tile::reg_fence(acc[i]);
    }
    int prev = -1;
#pragma unroll 1
    for (int st = 0; st < n_st; ++st, ++it) {
      const int slot = it % C::kStages;
      tile::mbar_wait(full + 8 * slot, (it / C::kStages) & 1);
      const uint32_t base = ring + slot * C::kStage;
      const uint32_t a = base + wg * 64 * kKBytes;
      const uint32_t b = base + C::kDbBytes;
      tile::wgmma_fence();
#pragma unroll
      for (int s = 0; s < kKBytes / 32; ++s) {
        tile::wgmma_ss<BQ>(acc, tile::sw128_desc(a + 32 * s), tile::sw128_desc(b + 32 * s));
      }
      tile::wgmma_commit();
      // the previous stage's group is done: release its slot
      tile::wgmma_wait<1>();
      if (prev >= 0 && lane == 0) tile::mbar_arrive(empty + 8 * prev);
      prev = slot;
    }
    tile::wgmma_wait<0>();
    if (lane == 0) tile::mbar_arrive(empty + 8 * prev);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) tile::reg_fence(acc[i]);

    // accumulator register 4q + 2h + e holds DB row (row + 8h), query row
    // 8q + 2t4 + e of the tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dn = d0 + row + 8 * h;
      if (dn >= n) continue;
#pragma unroll
      for (int q = 0; q < BQ / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qm = q0 + 8 * q + 2 * t4 + e;
          if (qm < m) __stcs(c + static_cast<size_t>(qm) * n + dn, acc[4 * q + 2 * h + e]);
        }
    }
  }
}

template <int BQ>
int launch(int grid, const void* q, const void* db, int m, int n, int k, void* c,
           cudaStream_t stream) {
  using C = GemmCfg<BQ>;
  CUtensorMap q_map;
  CUtensorMap db_map;
  if (!tma::make_map_2d(&q_map, q, m, k, kKBytes, BQ, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tma::make_map_2d(&db_map, db, n, k, kKBytes, kDbRows, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_qt = (m + BQ - 1) / BQ;
  const long long tiles = static_cast<long long>(n_qt) * ((n + kDbRows - 1) / kDbRows);
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_gemm_kernel<BQ><<<grid, kThreads, C::kSmem, stream>>>(
      q_map, db_map, m, n, k, n_qt, static_cast<int>(tiles), static_cast<int*>(c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mpc_iris

// bq: query rows per tile, 32, 64, 128 or 256; grid: persistent blocks (at
// most the tiles); q: int8 [m][k], db: int8 [n][k], both row-major and
// 16-byte aligned; c: int32 [m][n]; k a positive multiple of 128.
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for a tile width it was not built for or a tensor map it cannot encode).
extern "C" int int8_gemm_launch(int bq, int grid, const void* q, const void* db, int m, int n,
                                int k, void* c, void* stream) {
  using namespace mpc_iris;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (bq) {
    case 32: return launch<32>(grid, q, db, m, n, k, c, s);
    case 64: return launch<64>(grid, q, db, m, n, k, c, s);
    case 128: return launch<128>(grid, q, db, m, n, k, c, s);
    case 256: return launch<256>(grid, q, db, m, n, k, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
