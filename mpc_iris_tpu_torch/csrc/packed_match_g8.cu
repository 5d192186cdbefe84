// Kernels (b) and (c) for a launch of exactly 8 queries: the small-batch
// match and the audit spectrum over the BIT-PACKED template DB as ONE group
// of eight queries, on Hopper's int8 tensor cores. One tile loop computes
// each entry's exact minimum over the 31 rotations of n/d (ties to the
// earliest rotation) for the 8 queries; its epilogue is a template
// parameter, and the two kernels differ only there:
// - packed_match_kernel_g8 replaces, at B = 8, the TPU kernel
//   mpc_iris_tpu/ops/packed_match.py::match_packed_small_b (kernel body
//   _pk_select_kernel), as packed_match.cu does for groups of 2 and 4: per
//   query the winner (n, d, idx) over the WHOLE DB, the exact argmin over
//   entries (ties to the lowest global index). Each cluster leaves one
//   partial winner per query, int32 [3][8][n_parts], and fold_parts_kernel
//   (frac.cuh) folds them.
// - packed_fractions_kernel_g8 replaces, at B = 8, the TPU kernel
//   mpc_iris_tpu/ops/packed_match.py::fractions_packed_small_b (kernel body
//   _pk_fractions_kernel), as packed_fractions.cu does for groups of 2 and 4:
//   each entry's minimum (n, d) written as int16 planes [2][8][n_entries]
//   (an all-invalid or zero-padded entry (0, 0)). Nothing to fold; its
//   scratch is the exchange's slots alone.
//
// What bounds both on the H100: the two int8 products, 32 x 12,800 x 2 MACs
// per (query, entry): 6.73 ms for 8 queries at 1M entries at 1,979 TOPS
// (31 of the 32 rows a query count), against 1.00 ms to read the packed DB
// once (the spectrum writes 32 bytes an entry more, 0.01 ms at 1M).
// packed_tile.cuh's loop runs them in groups of 4 (N = 128, both products in
// every thread) at 44-47% of the int8 peak, its time following its count of
// wgmma instructions. packed_gemm.cu runs the same products over the same
// packed DB at 79-82% (PERF.md §6 row e); these kernels are its mainloop
// (packed_gemm.cuh, shared) with the rotation minimum fused:
// - The 8 queries' 256 rotation rows (row 31 of each zero: den 0, never
//   valid) are one wgmma N = 256: m64n256k32, both operands in shared
//   memory, the query rows in packed_gemm's K order
//   (ops/packed_gemm.py::kernel_k_order), the DB's packed words expanded per
//   bit-plane into a 2 KB A tile a K-step. A tile is 128 entries: two
//   consumer warpgroups of 64, a TMA producer thread, a ring of 3 stages of
//   256 K (72 KB), persistent.
// - Two m64n256 int32 accumulators do not fit one thread, and one block that
//   computes both products of its entries has to take in both query planes,
//   16 KB of shared memory a K-step from L2, twice packed_gemm's: a first
//   design that did so (one warpgroup a product over 64 entries, each query
//   plane loaded once for a 2-block cluster and multicast) ran at 32% of the
//   bound, the SMs' intake from L2 full (PERF.md §6 row b). So the product is
//   a cluster coordinate: the two blocks of a cluster take the same 128
//   entries, block 0 dot (the encoding against the query encodings), block 1
//   den (the mask against the query masks), each taking in one plane, as
//   packed_gemm does. Their accumulators share one fragment layout: thread t
//   of one holds the (entry, row) pairs of thread t of the other.
// - At a tile's end each block hands the other the 16-bit values (|dot|,
//   den <= 12,800) of the other's 4 queries, 32 KB, through a global
//   scratch slot that L2 holds (two slots a direction, so a block waits only
//   if the other is two tiles behind), each side signalling on the other's
//   mbarriers at cluster scope. Each block then takes for its own 4 queries
//   each entry's exact rotation minimum (in the thread, then across the quad
//   that shares the entry), and thread t4 of the quad takes query t4's: the
//   match folds it into a running winner, the spectrum stores it (8 lanes of
//   a warp 8 adjacent entries of one query, coalesced along the entry axis).
//   Block 0 keeps queries 0-3, block 1 queries 4-7, so both do half the
//   epilogue.
// - Before a block exits it waits until the other has read its last two
//   slots, so no remote arrival reaches a block that has exited.
#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "frac.cuh"
#include "packed_gemm.cuh"
#include "packed_tile.cuh"
#include "tensor_map.cuh"

namespace mpc_iris {
namespace {

using namespace gemm;

constexpr int kQueries = kQRows / 32;              // the group: 32 rotation rows a query
constexpr int kCluster = 2;                        // block 0 dot, block 1 den
constexpr int kBars = 2 * kStages + 2 * 2;         // the ring's; the exchange's, 2 slots
// 1,024 bytes of slack: the swizzled boxes need 1,024-byte alignment
constexpr int kSmem = 1024 + kBarOffset + kBars * 8;
constexpr int kKeep = kQueries / kCluster;         // queries whose winners a block keeps
constexpr int kXWords = kKeep * 16 / 2;            // handed over a tile: 2 values a word
constexpr int kXSlot = kConsumers * 128 * kXWords; // words of one slot (32 KB)
constexpr int kFrom = kKeep * 16;                  // the first register of block 0's gift
static_assert(kSmem + static_cast<int>(sizeof(Frac)) * kKeep * kConsumers * 4 <= 232448,
              "shared memory of one block");

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of both blocks of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Arrives on the mbarrier at `bar`'s offset in block `cta` of the cluster,
// this thread's earlier memory accesses ordered before it.
__device__ __forceinline__ void arrive_in(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 r;\n"
      "mapa.shared::cluster.u32 r, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [r];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ bool try_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// tile::mbar_wait for a barrier the other block arrives on, its accesses
// before the arrivals visible after; traps after 2^35 cycles instead of
// hanging the card.
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  if (try_wait_cluster(bar, parity)) return;
  const long long t0 = clock64();
  while (!try_wait_cluster(bar, parity)) {
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}

// The signed 16-bit value in half `hi` of word w.
__device__ __forceinline__ int half16(uint32_t w, int hi) {
  return hi ? static_cast<int>(w) >> 16 : static_cast<int>(static_cast<int16_t>(w & 0xFFFFu));
}

// The match's epilogue: the running winner of query kRank * 4 + t4 over the
// entries of this thread's quad.
struct KeepWinner {
  int n_entries;
  Frac run;
  __device__ __forceinline__ void entry(int q, int h, int t4, int e, Frac best) {
    if (t4 == q && e < n_entries) run = frac_select(run, Frac{best.n, best.d, e});
  }
  __device__ __forceinline__ void end_tile(int e0) {}
};

// The spectrum's epilogue: query kRank * 4 + t4's (n, d) of this thread's two
// entries of each tile, stored at the tile's end: n at row[e], d at
// row[plane + e].
struct WriteSpectrum {
  int16_t* row;
  long long plane;
  int n_entries;
  int n[2];
  int d[2];
  __device__ __forceinline__ void entry(int q, int h, int t4, int e, Frac best) {
    if (t4 == q) {
      n[h] = best.n;
      d[h] = best.d;
    }
  }
  __device__ __forceinline__ void end_tile(int e0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + 8 * h;
      if (e < n_entries) {
        row[e] = static_cast<int16_t>(n[h]);
        row[plane + e] = static_cast<int16_t>(d[h]);
      }
    }
  }
};

// A consumer thread of block kRank (0: dot, queries 0-3 kept; 1: den,
// queries 4-7 kept) over the cluster's tiles; hands `keep` each entry's
// rotation minimum of each kept query (entry(q, h, t4, e, best) for entry e,
// row + 8h of the tile, in every thread of the quad), then end_tile(e0) at
// each tile's end.
template <int kRank, class Keep>
__device__ __forceinline__ void consumer(uint32_t ring, uint32_t full, uint32_t empty,
                                         uint32_t a_tiles, uint32_t xfull, uint32_t xempty,
                                         uint32_t* __restrict__ xg, int cluster, int clusters,
                                         int tiles, Keep& keep) {
  constexpr int kGive = kRank == 0 ? kFrom : 0;   // the registers of the other's queries
  constexpr int kOwn = kRank == 0 ? 0 : kFrom;
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row = wg * 64 + (ct / 32) % 4 * 16 + (lane >> 2);  // + 8h: the entry of the tile
  // slot words: [cluster][sender][slot][k][consumer thread]
  uint32_t* const give = xg + static_cast<size_t>(cluster * kCluster + kRank) * 2 * kXSlot + ct;
  const uint32_t* const take =
      xg + static_cast<size_t>(cluster * kCluster + (1 - kRank)) * 2 * kXSlot + ct;
  int acc[128];
  int it = 0;
  int j = 0;
  for (int t = cluster; t < tiles; t += clusters, ++j) {
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      acc[i] = 0;
      tile::reg_fence(acc[i]);
    }
    it = tile_products<kRank == 0>(acc, it, ring, full, empty, a_tiles, wg, row, lane);
#pragma unroll
    for (int i = 0; i < 128; ++i) tile::reg_fence(acc[i]);

    // hand over the other's queries: slot s, once the other has read it
    // two tiles ago; then take the other's values of this block's queries
    const int s = j & 1;
    const uint32_t phase = (j >> 1) & 1;
    wait_cluster(xempty + 8 * s, phase ^ 1);
#pragma unroll
    for (int k = 0; k < kXWords; ++k) {
      const uint32_t lo = static_cast<uint32_t>(acc[kGive + 2 * k]) & 0xFFFFu;
      const uint32_t hi = static_cast<uint32_t>(acc[kGive + 2 * k + 1]) << 16;
      __stcg(give + s * kXSlot + k * (kConsumers * 128), lo | hi);
    }
    arrive_in(xfull + 8 * s, 1 - kRank);
    wait_cluster(xfull + 8 * s, phase);
    uint32_t other[kXWords];
#pragma unroll
    for (int k = 0; k < kXWords; ++k) other[k] = __ldcg(take + s * kXSlot + k * (kConsumers * 128));
    arrive_in(xempty + 8 * s, 1 - kRank);

    const int e0 = t * kDbRows + row;
#pragma unroll
    for (int q = 0; q < kKeep; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // register 16q + 4c + 2h + e: rotation 8c + 2 t4 + e of the query
        Frac best = frac_pad();
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 16 * q + 4 * c + 2 * h + e;
            const int mine = acc[kOwn + k];
            const int theirs = half16(other[k >> 1], k & 1);
            const int dot = kRank == 0 ? mine : theirs;
            const int den = kRank == 0 ? theirs : mine;
            best = frac_select(best, Frac{(den - dot) >> 1, den, 8 * c + 2 * t4 + e});
          }
        best = tile::quad_select(best);
        keep.entry(q, h, t4, e0 + 8 * h, best);
      }
    keep.end_tile(e0);
  }
  // the other block has read this block's last two slots
  for (int k = 0; k < 2; ++k, ++j) wait_cluster(xempty + 8 * (j & 1), ((j >> 1) & 1) ^ 1);
}

// Both kernels' block over the cluster's tiles: the barriers, then the
// producer thread's copies, or a consumer thread's tiles handed to `keep`.
// Returns false in the producer warpgroup, true in a consumer thread past
// its last tile.
template <class Keep>
__device__ __forceinline__ bool cluster_tiles(const CUtensorMap* q_map, const CUtensorMap* pat_map,
                                              const CUtensorMap* msk_map, int tiles,
                                              uint32_t* __restrict__ xg, uint32_t rank,
                                              int cluster, int clusters, Keep& keep) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (tile::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kBarOffset;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t xfull = empty + 8 * kStages;
  const uint32_t xempty = xfull + 8 * 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tile::mbar_init(full + 8 * s, 1);                 // the producer's expect_tx
      tile::mbar_init(empty + 8 * s, kConsumers * 4);   // one arrival a consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      tile::mbar_init(xfull + 8 * s, kConsumers * 128);   // every consumer thread of the other
      tile::mbar_init(xempty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the other block's barriers are ready before any arrival
  cluster_sync();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy
    tile::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(q_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(pat_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(msk_map))
                   : "memory");
      // block 0 the encoding rows against the pattern and mask, block 1 the
      // mask rows against the mask
      const int qy = static_cast<int>(rank) * kQRows;
      const uint32_t bytes = 2 * kQBox + (rank == 0 ? 2 : 1) * kDbBox;
      int it = 0;
      for (int t = cluster; t < tiles; t += clusters) {
        const int d0 = t * kDbRows;
        for (int js = 0; js < kStagesPerTile; ++js, ++it) {
          const int slot = it % kStages;
          tile::mbar_wait(empty + 8 * slot, ((it / kStages) & 1) ^ 1);
          const uint32_t base = ring + slot * kStage;
          const uint32_t bar = full + 8 * slot;
          tile::mbar_expect_tx(bar, bytes);
          tile::tma_load_2d(base, q_map, js * kStageK, qy, bar);
          tile::tma_load_2d(base + kQBox, q_map, js * kStageK + 128, qy, bar);
          if (rank == 0) tile::tma_load_2d(base + kPatOffset, pat_map, js * kSlab, d0, bar);
          tile::tma_load_2d(base + kMskOffset, msk_map, js * kSlab, d0, bar);
        }
      }
    }
    return false;
  }

  // ---- consumer warpgroups: 64 entries each against the 256 query rows
  tile::regs_inc<kConsumerRegs>();
  const uint32_t a_tiles = ring + kATiles;
  if (rank == 0) {
    consumer<0>(ring, full, empty, a_tiles, xfull, xempty, xg, cluster, clusters, tiles, keep);
  } else {
    consumer<1>(ring, full, empty, a_tiles, xfull, xempty, xg, cluster, clusters, tiles, keep);
  }
  return true;
}

// grid: clusters of 2 blocks, persistent over `tiles` = ceil(n / 128) tiles
// of 128 entries; q_map: int8 [512][12800] (the 8 queries' encoding rows,
// then their mask rows, 32 a query) in packed_gemm's K order; pat_map,
// msk_map: uint8 [n][1600]; part: int32 [3][8][gridDim.x / 2]; xg: uint32
// [gridDim.x / 2][2][2][kXSlot], the exchange's slots.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
packed_match_kernel_g8(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap pat_map,
                       const __grid_constant__ CUtensorMap msk_map, int n_entries, int tiles,
                       int* __restrict__ part, uint32_t* __restrict__ xg) {
  __shared__ Frac s_best[kKeep][kConsumers * 4];
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;
  KeepWinner keep{n_entries, frac_pad()};
  if (!cluster_tiles(&q_map, &pat_map, &msk_map, tiles, xg, rank, cluster, clusters, keep)) {
    return;
  }

  // the block's winner per kept query: lanes of one t4, then the 8 warps
  const int ct = threadIdx.x - 128;
  const int lane = threadIdx.x & 31;
  Frac f = keep.run;
#pragma unroll
  for (int s = 4; s < 32; s <<= 1) {
    const Frac o{__shfl_xor_sync(0xffffffffu, f.n, s), __shfl_xor_sync(0xffffffffu, f.d, s),
                 __shfl_xor_sync(0xffffffffu, f.i, s)};
    f = frac_select(f, o);
  }
  if (lane < kKeep) s_best[lane][ct / 32] = f;
  asm volatile("bar.sync 3, %0;" ::"n"(kConsumers * 128) : "memory");
  if (ct < kKeep) {
    f = s_best[ct][0];
#pragma unroll
    for (int w = 1; w < kConsumers * 4; ++w) f = frac_select(f, s_best[ct][w]);
    const size_t plane = static_cast<size_t>(kQueries) * clusters;
    const size_t at = static_cast<size_t>(rank * kKeep + ct) * clusters + cluster;
    part[at] = f.n;
    part[plane + at] = f.d;
    part[2 * plane + at] = f.i;
  }
}

// grid, q_map, pat_map, msk_map and xg as for packed_match_kernel_g8; out:
// int16, query q's n at out[q * n_entries + e] and its d at out[plane + q *
// n_entries + e].
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
packed_fractions_kernel_g8(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap pat_map,
                           const __grid_constant__ CUtensorMap msk_map, int n_entries, int tiles,
                           int16_t* __restrict__ out, long long plane,
                           uint32_t* __restrict__ xg) {
  const uint32_t rank = cluster_rank();
  const int q = static_cast<int>(rank) * kKeep + (threadIdx.x & 3);
  WriteSpectrum keep{out + static_cast<size_t>(q) * n_entries, plane, n_entries, {0, 0}, {0, 0}};
  cluster_tiles(&q_map, &pat_map, &msk_map, tiles, xg, rank, blockIdx.x / kCluster,
                gridDim.x / kCluster, keep);
}

// One of this file's kernels, and by device the most clusters of it the
// device holds at once (0 until asked).
struct Kernel {
  const void* fn;
  int most[64];
};

Kernel& match_kernel() {
  static Kernel k{reinterpret_cast<const void*>(packed_match_kernel_g8), {}};
  return k;
}

Kernel& spectrum_kernel() {
  static Kernel k{reinterpret_cast<const void*>(packed_fractions_kernel_g8), {}};
  return k;
}

int max_clusters(Kernel& k) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (k.most[dev] == 0) {
    if (cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem) !=
        cudaSuccess) {
      return 0;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = kSmem;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, k.fn, &cfg) != cudaSuccess) return 0;
    k.most[dev] = n;
  }
  return k.most[dev];
}

// The clusters of a launch of `k` over n entries: one a tile, at most what
// the device holds at once.
int clusters_for(Kernel& k, long long n_entries) {
  const long long tiles = (n_entries + kDbRows - 1) / kDbRows;
  const int most = max_clusters(k);
  return static_cast<int>(tiles < most ? tiles : most);
}

// A launch's tensor maps and grid.
struct Grid {
  CUtensorMap q_map;
  CUtensorMap pat_map;
  CUtensorMap msk_map;
  int clusters;
  int tiles;
};

// Encodes the maps of q, dp, dm (as the launches below take them) and sizes
// the grid of `k` over n_entries; returns 0, or the CUDA error
// (cudaErrorInvalidValue for a map it cannot encode or an entry count it
// does not take).
int make_grid(Kernel& k, const void* q, const void* dp, const void* dm, long long n_entries,
              Grid* g) {
  if (n_entries < 1 || n_entries > INT_MAX - kDbRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!tma::make_map_2d(&g->q_map, q, 2 * kQRows, kK, 128, kQRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tma::make_map_2d(&g->pat_map, dp, n_entries, tile::kPlane, kSlab, kDbRows,
                        CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tma::make_map_2d(&g->msk_map, dm, n_entries, tile::kPlane, kSlab, kDbRows,
                        CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  g->clusters = clusters_for(k, n_entries);
  if (g->clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  g->tiles = static_cast<int>((n_entries + kDbRows - 1) / kDbRows);
  return 0;
}

}  // namespace
}  // namespace mpc_iris

// int32 words of scratch match_packed_g8_launch takes for n_entries entries
// on the current device: the partial winners, int32 [3][8][clusters], then
// the exchange's slots, 128 KB a cluster. 0 where the device cannot run it.
extern "C" int match_packed_g8_scratch(long long n_entries) {
  using namespace mpc_iris;
  return clusters_for(match_kernel(), n_entries) * (3 * kQueries + kCluster * 2 * kXSlot);
}

// One launch (and its fold) for 8 queries: q int8 [512][12800], the 8
// queries' encoding rows then their mask rows (32 a query, row 31 zero) in
// packed_gemm's K order, 16-byte aligned; dp, dm uint8 [n_entries][1600],
// 16-byte aligned; scratch int32 [match_packed_g8_scratch(n_entries)],
// 16-byte aligned; out: int32 [3] rows of out_stride, query 0 at column 0.
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for a tensor map it cannot encode or an entry count it does not take).
extern "C" int match_packed_g8_launch(const void* q, const void* dp, const void* dm,
                                      long long n_entries, void* scratch, void* out,
                                      int out_stride, void* stream) {
  using namespace mpc_iris;
  Grid g;
  const int bad = make_grid(match_kernel(), q, dp, dm, n_entries, &g);
  if (bad) return bad;
  auto s = static_cast<cudaStream_t>(stream);
  int* part = static_cast<int*>(scratch);
  auto* xg = reinterpret_cast<uint32_t*>(part + 3 * kQueries * g.clusters);
  packed_match_kernel_g8<<<kCluster * g.clusters, kThreads, kSmem, s>>>(
      g.q_map, g.pat_map, g.msk_map, static_cast<int>(n_entries), g.tiles, part, xg);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_parts_kernel<<<kQueries, kFoldThreads, 0, s>>>(part, g.clusters, kQueries,
                                                      static_cast<int*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

// int32 words of scratch fractions_packed_g8_launch takes for n_entries
// entries on the current device: the exchange's slots, 128 KB a cluster. 0
// where the device cannot run it.
extern "C" int fractions_packed_g8_scratch(long long n_entries) {
  using namespace mpc_iris;
  return clusters_for(spectrum_kernel(), n_entries) * kCluster * 2 * kXSlot;
}

// One launch for 8 queries: q, dp, dm as for match_packed_g8_launch; scratch
// int32 [fractions_packed_g8_scratch(n_entries)], 16-byte aligned; out:
// int16, query 0's n plane row (its d row is `plane` elements further),
// query q's row q * n_entries elements after query 0's. Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue as above).
extern "C" int fractions_packed_g8_launch(const void* q, const void* dp, const void* dm,
                                          long long n_entries, void* scratch, void* out,
                                          long long plane, void* stream) {
  using namespace mpc_iris;
  Grid g;
  const int bad = make_grid(spectrum_kernel(), q, dp, dm, n_entries, &g);
  if (bad) return bad;
  packed_fractions_kernel_g8<<<kCluster * g.clusters, kThreads, kSmem,
                               static_cast<cudaStream_t>(stream)>>>(
      g.q_map, g.pat_map, g.msk_map, static_cast<int>(n_entries), g.tiles,
      static_cast<int16_t*>(out), plane, static_cast<uint32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
