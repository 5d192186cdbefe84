// Exact int8 product C[M, N] = A[M, K] . B[N, K]^T with int32 sums, on
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
// scan's products of a B = 128 request) the 2 x 4,096 x 16,384 x 12,800 =
// 1.72e12 int8 operations take 0.868 ms at 1,979 TOPS, against 0.16 ms to
// move its 530 MB once: operations. Design (the tile loop of
// packed_tile.cuh without the unpacking):
// - B's rows are the wgmma M side (64 rows per warpgroup and M tile, two M
//   tiles per warpgroup, two warpgroups: 256 rows of B per block), read from
//   shared memory into registers (wgmma's register-A operand); A's rows are
//   the N side (32, 64 or 128 per block), read by wgmma from shared memory.
// - The wrapper lays A out once per call in exactly the order wgmma reads it
//   (K-major, no swizzle, core matrices of 8 rows x 16 bytes), so a stage of
//   4 K-steps is one contiguous slab and one bulk async copy.
// - A ring of 3 stages: each stage 4 K-steps (128 bytes) of the block's 256
//   rows of B (16-byte cp.async from every thread, rows padded by 16 bytes
//   so the fragment loads are conflict-free) and of its A rows; full and
//   empty mbarriers per stage, the next stages in flight during the products.
// - Blocks of one tile of B for the tiles of A are adjacent in the grid, so
//   B is read from device memory once and from L2 for the other tiles of A.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_tile.cuh"

namespace mpc_iris {
namespace {

constexpr int kThreads = 256;                      // two warpgroups
constexpr int kMt = 2;                             // 64-row M tiles per warpgroup
constexpr int kRows = kThreads / 128 * kMt * 64;   // 256 rows of B per block
constexpr int kSteps = 4;                          // 32-byte K-steps per stage
constexpr int kStages = 3;
constexpr int kRowBytes = kSteps * 32 + 16;        // padded row of a B stage

// N: rows of A per block, the wgmma N (32, 64 or 128).
template <int N>
struct GemmCfg {
  static constexpr int kABytes = kSteps * N * 32;       // one stage of A slabs
  static constexpr int kBBytes = kRows * kRowBytes;     // one stage of B rows
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int kBarOffset = kStages * kStage;
  static constexpr int kSmem = kBarOffset + 3 * kStages * 8;
  static_assert(kABytes % 128 == 0 && kStage % 128 == 0, "stage alignment");
  static_assert(kMt * N / 2 <= 128, "accumulators must fit the register file");
};

// grid: n_btiles * n_atiles; block x = btile * n_atiles + atile.
// at: int8 [n_atiles][k / 32][N / 8][2][8][16], A laid out by the wrapper
// (rows past m zero); b: int8 [n][k]; c: int32 [m][n].
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_kernel(const int8_t* __restrict__ at, const int8_t* __restrict__ b, int m, int n,
                 int k, int n_atiles, int* __restrict__ c) {
  using C = GemmCfg<N>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int atile = blockIdx.x % n_atiles;
  const long long brow0 = static_cast<long long>(blockIdx.x / n_atiles) * kRows;
  const long long left = n - brow0;
  const int valid = left < kRows ? static_cast<int>(left) : kRows;
  const int n_st = k / (32 * kSteps);
  const int8_t* a = at + static_cast<size_t>(atile) * (k / 32) * N * 32;
  const uint32_t a_full = tile::smem_addr(smem + C::kBarOffset);
  const uint32_t b_full = a_full + 8 * kStages;
  const uint32_t empty = b_full + 8 * kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tile::mbar_init(a_full + 8 * s, 1);
      tile::mbar_init(b_full + 8 * s, kThreads);
      tile::mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Every thread: waits for stage st's slot to be free, then copies its
  // pieces of the stage; thread 0 also the stage's A slab.
  auto fetch = [&](int st) {
    const int slot = st % kStages;
    tile::mbar_wait(empty + 8 * slot, ((st / kStages) & 1) ^ 1);
    uint8_t* base = smem + slot * C::kStage;
    if (threadIdx.x == 0) {
      tile::mbar_expect_tx(a_full + 8 * slot, C::kABytes);
      tile::bulk_copy(tile::smem_addr(base), a + static_cast<size_t>(st) * C::kABytes,
                      C::kABytes, a_full + 8 * slot);
    }
    const uint32_t sb = tile::smem_addr(base + C::kABytes);
    constexpr int kPieces = kSteps * 32 / 16;
    for (int i = threadIdx.x; i < kRows * kPieces; i += kThreads) {
      const int row = i / kPieces;
      const int piece = i % kPieces;
      if (row < valid) {
        tile::cp_async16(sb + row * kRowBytes + piece * 16,
                         b + (brow0 + row) * k + st * kSteps * 32 + piece * 16);
      }
    }
    tile::cp_async_arrive(b_full + 8 * slot);
  };

  for (int st = 0; st < kStages - 1 && st < n_st; ++st) fetch(st);

  const int t = threadIdx.x & 3;
  int acc[kMt][N / 2];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0;

#pragma unroll 1
  for (int st = 0; st < n_st; ++st) {
    if (st + kStages - 1 < n_st) fetch(st + kStages - 1);
    const int slot = st % kStages;
    const uint32_t parity = (st / kStages) & 1;
    tile::mbar_wait(b_full + 8 * slot, parity);
    tile::mbar_wait(a_full + 8 * slot, parity);
    const uint8_t* sb = smem + slot * C::kStage + C::kABytes;
    const uint32_t sa = tile::smem_addr(smem + slot * C::kStage);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      // A fragment registers a0..a3: rows (g, g+8) x K (4t..4t+3,
      // 16+4t..16+4t+3) of the warp's 16 rows
      uint32_t frag[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = tile::tile_row<kMt>(mt, i & 1);
          frag[mt][i] = *reinterpret_cast<const uint32_t*>(
              sb + r * kRowBytes + s * 32 + (i >> 1) * 16 + 4 * t);
          tile::reg_fence(frag[mt][i]);
        }
      tile::wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        tile::wgmma_s8<N>(acc[mt], frag[mt], tile::slab_desc(sa + s * N * 32));
      }
      tile::wgmma_commit();
    }
    tile::wgmma_wait<0>();
    tile::mbar_arrive(empty + 8 * slot);
  }
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tile::reg_fence(acc[mt][i]);

  // accumulator register 4q + 2h + e holds row (g + 8h) of B, row 8q + 2t + e of A
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile::tile_row<kMt>(mt, h);
      if (r >= valid) continue;
#pragma unroll
      for (int q = 0; q < N / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row_a = atile * N + 8 * q + 2 * t + e;
          if (row_a < m) {
            c[static_cast<size_t>(row_a) * n + brow0 + r] = acc[mt][4 * q + 2 * h + e];
          }
        }
    }
}

template <int N>
int launch(const void* at, const void* b, int m, int n, int k, void* c, cudaStream_t stream) {
  using C = GemmCfg<N>;
  const int n_atiles = (m + N - 1) / N;
  const long long blocks = static_cast<long long>(n_atiles) * ((n + kRows - 1) / kRows);
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_gemm_kernel<N><<<static_cast<unsigned>(blocks), kThreads, C::kSmem, stream>>>(
      static_cast<const int8_t*>(at), static_cast<const int8_t*>(b), m, n, k, n_atiles,
      static_cast<int*>(c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mpc_iris

// tile_rows: rows of A per block, 32, 64 or 128; at: A laid out for it
// (int8_gemm_kernel); b: int8 [n][k], 16-byte aligned; c: int32 [m][n]; k a
// positive multiple of 128.
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for a tile width it was not built for).
extern "C" int int8_gemm_launch(int tile_rows, const void* at, const void* b, int m, int n,
                                int k, void* c, void* stream) {
  using namespace mpc_iris;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tile_rows) {
    case 32: return launch<32>(at, b, m, n, k, c, s);
    case 64: return launch<64>(at, b, m, n, k, c, s);
    case 128: return launch<128>(at, b, m, n, k, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
