// The mainloop of packed_gemm.cu, shared with packed_match_g8.cu: a
// warp-specialized block (one TMA producer thread, two consumer warpgroups
// of 64 DB entries) takes one tile of 128 entries x 256 query rows of ONE
// int8 product over the BIT-PACKED DB through a ring of 3 stages of 256 K
// (the query rows' two 128-byte boxes, 128-byte swizzle, and 32 packed bytes
// of each entry's pattern and mask planes), expanding the packed words per
// bit-plane into a 2 KB A tile a K-step for wgmma m64n256k32. packed_gemm.cu
// says why it is built so; the kernels around it differ in their walk and
// epilogue.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "packed_tile.cuh"

namespace mpc_iris {
namespace gemm {

constexpr int kK = 12800;                          // K: 8 bit-planes x 1,600 bytes
constexpr int kConsumers = 2;                      // warpgroups running wgmma
constexpr int kThreads = (kConsumers + 1) * 128;   // and one producer warpgroup
constexpr int kDbRows = kConsumers * 64;           // DB rows per tile (wgmma M)
constexpr int kQRows = 256;                        // query rows per tile (wgmma N)
constexpr int kSlab = 32;                          // packed bytes per entry and stage
constexpr int kStageK = 8 * kSlab;                 // K per stage: the slab's 8 bit-planes
constexpr int kStagesPerTile = tile::kPlane / kSlab;  // 50
constexpr int kQBox = kQRows * 128;                // one query box: 128 bytes of K
constexpr int kDbBox = kDbRows * kSlab;            // one plane's packed slab
constexpr int kPatOffset = 2 * kQBox;
constexpr int kMskOffset = kPatOffset + kDbBox;
constexpr int kStage = 2 * kQBox + 2 * kDbBox;     // 72 KB
constexpr int kStages = 3;
constexpr int kATile = 64 * 32;                    // a warpgroup's A tile of one K-step
constexpr int kABufs = 2;
constexpr int kATiles = kStages * kStage;          // the A tiles, after the ring
constexpr int kBarOffset = kATiles + kConsumers * kABufs * kATile;  // the barriers, after them
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kStage % 1024 == 0, "1,024-byte-aligned stages (128-byte swizzle)");

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Hands a ring slot back to the producer: every thread's loads from it are
// ordered before the TMA's refill, then one arrival a warp.
__device__ __forceinline__ void release(uint32_t empty, int slot, int lane) {
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) tile::mbar_arrive(empty + 8 * slot);
}

// One tile's products over its 50 stages into acc (register 4q + 2h + e:
// DB row `row` + 8h, query row 8q + 2 t4 + e of the tile). `it` counts the
// block's stages; returns it past this tile.
template <bool kEnc>
__device__ __forceinline__ int tile_products(int (&acc)[128], int it, uint32_t ring,
                                             uint32_t full, uint32_t empty, uint32_t a_tiles,
                                             int wg, int row, int lane) {
  const int warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  int prev = -1;
#pragma unroll 1
  for (int js = 0; js < kStagesPerTile; ++js, ++it) {
    const int slot = it % kStages;
    tile::mbar_wait(full + 8 * slot, (it / kStages) & 1);
    const uint32_t base = ring + slot * kStage;
    // this thread's packed words: A fragment register i holds DB row
    // row + 8 (i & 1), K bytes 16 (i >> 1) + 4 t4 .. + 3 of the K-step
    uint32_t m[4];
    uint32_t pm[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off = (row + 8 * (i & 1)) * kSlab + 16 * (i >> 1) + 4 * t4;
      m[i] = lds(base + kMskOffset + off);
      pm[i] = kEnc ? lds(base + kPatOffset + off) & m[i] : 0u;
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = (m[i] >> b) & tile::kLsb;
        if (kEnc) a[i] += ((pm[i] >> b) & tile::kLsb) * 0xFEu;
      }
      // bit-plane b of the slab: query box b / 4, its 32-byte K-step b % 4
      const uint64_t desc_b = tile::sw128_desc(base + (b >> 2) * kQBox + 32 * (b & 3));
      // the A tile in slab_desc's core-matrix layout: 8-row groups 256
      // bytes apart, the two 16-byte K halves 128 bytes apart, rows 16
      // bytes apart; this K-step's tile was last read two K-steps ago
      const uint32_t at = a_tiles + (wg * kABufs + (b & 1)) * kATile;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sts(at + (2 * warp + (i & 1)) * 256 + (i >> 1) * 128 + g * 16 + 4 * t4, a[i]);
      }
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      tile::wgmma_fence();
      tile::wgmma_ss<kQRows>(acc, tile::slab_desc(at), desc_b);
      tile::wgmma_commit();
      // the K-step before this one is done (and with it, at b = 0, the
      // previous stage): its A tile may be rewritten, its slot refilled
      tile::wgmma_wait<1>();
      if (b == 0) {
        if (prev >= 0) release(empty, prev, lane);
        prev = slot;
      }
    }
  }
  tile::wgmma_wait<0>();
  release(empty, prev, lane);
  return it;
}

}  // namespace gemm
}  // namespace mpc_iris
