// Both int8 products of the scan over one BIT-PACKED DB chunk, on Hopper's
// int8 tensor cores (wgmma), the DB read as packed bits and never written
// out unpacked:
//   dot[M, c] = QE[M, K] . enc[c, K]^T,   den[M, c] = QM[M, K] . mask[c, K]^T
// with the ring encoding enc = m - 2 (p & m) in {-1, 0, 1} of the chunk's
// packed pattern and mask planes, uint8 [c][1600] each, and int32 sums.
//
// Replaces the XLA products of the TPU package's packed scan
// (mpc_iris_tpu/models/engines.py::_match_scan_packed and
// _fractions_scan_packed: _unpack_encode_chunk, then dot_bits_batch_i4 twice
// a chunk), which no Pallas kernel computes; the port ran them as an unpack
// into two int8 [c, 12,800] planes and two torch._int_mm calls.
//
// What bounds it on the H100: at [4,096 x 12,800] query rows against a
// 16,384-entry chunk (a B = 128 request, 184 chunks at 3M entries) the
// 3.44e12 int8 operations take 1.736 ms at 1,979 TOPS, against 0.19 ms to
// read the 105 MB of query rows and the 52 MB of packed chunk once and write
// the 537 MB of products: operations. Design (int8_gemm.cu's, with a packed
// DB side; warp-specialized, persistent; the mainloop in packed_gemm.cuh,
// which packed_match_g8.cu shares):
// - K in the kernel's order (ops/packed_gemm.py::kernel_k_order): per
//   32-byte slab of packed bytes, its 8 bit-planes of 32 K each, so a K-step
//   of 32 is one bit-plane of 32 packed bytes and a stage of 256 K is one
//   slab of every entry. The wrapper permutes the query rows into this order
//   once a request, both products' rows in one [2M, K] tensor.
// - A tile is 128 DB rows x 256 query rows of ONE product: two m64n256 int32
//   accumulators (128 registers each) do not fit a thread, so the product is
//   a tile coordinate. Tiles are walked in groups of `group` query tiles
//   (query tile fastest inside a group), so that the blocks in flight share
//   a few query tiles and many DB tiles in L2.
// - One producer thread keeps a ring of 3 stages full by TMA: the slab's 256
//   K of the tile's query rows (two 128-byte boxes, 128-byte swizzle) and 32
//   packed bytes of each of the tile's 128 entries (pattern plane for dot
//   tiles only, mask plane always); rows past the tensors' ends arrive as
//   zeros (d = 0). Two consumer warpgroups, 64 entries each, load their
//   packed words once a stage and expand them per bit-plane b as
//   packed_tile.cuh does: mask (w >> b) & 0x01010101, encoding
//   mask + ((p & m) >> b & 0x01010101) * 0xFE. Each warpgroup writes the
//   expanded 64 x 32 A tile of a K-step into shared memory (two tiles in
//   turn; fence.proxy.async and a named barrier of its 128 threads before
//   wgmma reads it), and wgmma m64n256k32 takes both operands from shared
//   memory. A from registers, packed_tile.cuh's way, measured 2-4% slower
//   (2.21-2.27 against 2.14-2.19 ms a chunk, PERF.md): ptxas serializes its
//   wgmmas, whose A registers other instructions define. One wgmma group
//   stays in flight; a stage goes back to the TMA once its last products are
//   done (after fence.proxy.async, as b1_packed.cu learned).
// - Persistent: one block an SM; the producer fills the next tile's stages
//   while the consumers store this tile's accumulators (streaming stores).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_gemm.cuh"
#include "packed_tile.cuh"
#include "tensor_map.cuh"

namespace mpc_iris {
namespace {

using namespace gemm;

// 1,024 bytes of slack: the swizzled boxes need 1,024-byte alignment
constexpr int kSmem = 1024 + kBarOffset + 2 * kStages * 8;
static_assert(kSmem <= 232448, "shared memory of one block");

struct Tile {
  int p;   // 0: dot (QE against the encoding), 1: den (QM against the mask)
  int q0;  // first query row of the product
  int d0;  // first DB row
};

// Tile t of the walk: groups of `group` (product, query tile) columns u =
// p * n_qt + qt, each group's tiles with u fastest, then the DB tile.
__device__ __forceinline__ Tile tile_at(int t, int n_qt, int n_dt, int group) {
  const int per_group = group * n_dt;
  const int u0 = t / per_group * group;
  const int width = min(group, 2 * n_qt - u0);
  const int r = t - u0 * n_dt;
  const int u = u0 + r % width;
  return {u / n_qt, u % n_qt * kQRows, r / width * kDbRows};
}

// grid: persistent blocks over `tiles` = 2 n_qt n_dt tiles; q_map: int8
// [2m][kK] (QE rows, then QM rows) in the kernel's K order; pat_map, msk_map:
// uint8 [n][1600]; out: int32 [2][m][n] (dot, den).
__global__ void __launch_bounds__(kThreads, 1)
packed_gemm_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap pat_map,
                   const __grid_constant__ CUtensorMap msk_map, int m, int n, int n_qt,
                   int n_dt, int group, int tiles, int* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (tile::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kBarOffset;
  const uint32_t empty = full + 8 * kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&pat_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&msk_map))
                   : "memory");
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, n_qt, n_dt, group);
        const int qy = tl.p * m + tl.q0;
        const uint32_t bytes = 2 * kQBox + (tl.p == 0 ? 2 : 1) * kDbBox;
        for (int js = 0; js < kStagesPerTile; ++js, ++it) {
          const int slot = it % kStages;
          tile::mbar_wait(empty + 8 * slot, ((it / kStages) & 1) ^ 1);
          const uint32_t base = ring + slot * kStage;
          const uint32_t bar = full + 8 * slot;
          tile::mbar_expect_tx(bar, bytes);
          tile::tma_load_2d(base, &q_map, js * kStageK, qy, bar);
          tile::tma_load_2d(base + kQBox, &q_map, js * kStageK + 128, qy, bar);
          if (tl.p == 0) tile::tma_load_2d(base + kPatOffset, &pat_map, js * kSlab, tl.d0, bar);
          tile::tma_load_2d(base + kMskOffset, &msk_map, js * kSlab, tl.d0, bar);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 entries each against the tile's 256 query rows
  tile::regs_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row = wg * 64 + (threadIdx.x / 32) % 4 * 16 + (lane >> 2);  // + 8h
  const uint32_t a_tiles = ring + kATiles;
  int acc[128];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, n_qt, n_dt, group);
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      acc[i] = 0;
      tile::reg_fence(acc[i]);
    }
    it = tl.p == 0 ? tile_products<true>(acc, it, ring, full, empty, a_tiles, wg, row, lane)
                   : tile_products<false>(acc, it, ring, full, empty, a_tiles, wg, row, lane);
#pragma unroll
    for (int i = 0; i < 128; ++i) tile::reg_fence(acc[i]);

    int* __restrict__ o = out + static_cast<size_t>(tl.p) * m * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dn = tl.d0 + row + 8 * h;
      if (dn >= n) continue;
#pragma unroll
      for (int q = 0; q < kQRows / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qm = tl.q0 + 8 * q + 2 * t4 + e;
          if (qm < m) __stcs(o + static_cast<size_t>(qm) * n + dn, acc[4 * q + 2 * h + e]);
        }
    }
  }
}

}  // namespace
}  // namespace mpc_iris

// grid: persistent blocks (at most the tiles); group: query tiles a group of
// the walk; q: int8 [2m][12800] in the kernel's K order, 16-byte aligned;
// pat, msk: uint8 [n][1600], row-major, 16-byte aligned; out: int32
// [2][m][n]. Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for a tensor map it cannot encode or a bad plan).
extern "C" int packed_gemm_launch(int grid, int group, const void* q, const void* pat,
                                  const void* msk, int m, int n, void* out, void* stream) {
  using namespace mpc_iris;
  CUtensorMap q_map;
  CUtensorMap pat_map;
  CUtensorMap msk_map;
  if (!tma::make_map_2d(&q_map, q, 2LL * m, kK, 128, kQRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tma::make_map_2d(&pat_map, pat, n, tile::kPlane, kSlab, kDbRows,
                        CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tma::make_map_2d(&msk_map, msk, n, tile::kPlane, kSlab, kDbRows,
                        CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_qt = (m + kQRows - 1) / kQRows;
  const int n_dt = (n + kDbRows - 1) / kDbRows;
  const long long tiles = 2LL * n_qt * n_dt;
  if (tiles >= (1LL << 31) || group < 1 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(packed_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_gemm_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      q_map, pat_map, msk_map, m, n, n_qt, n_dt, group, static_cast<int>(tiles),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
