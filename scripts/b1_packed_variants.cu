// The measured alternatives to the B = 1 pk-dot kernel of
// mpc_iris_tpu_torch/csrc/b1_packed.cu, built into a library of their own
// by scripts/b1_packed_variants_torch.py (nvcc -I mpc_iris_tpu_torch/csrc):
// the int8 design and the issue-rate micro-kernel of the binary tensor
// instruction the shipped design runs on. The package does not build them.
//
// The int8 design (pk_dot_int8_kernel): DB entries on wgmma's N side, N =
// 256, both products in one accumulator. With pm = p & m, enc = m - 2 pm,
// so per K-step (bit-plane b, 32-byte slab jj) two SS-mode m64n256k32
// wgmmas run into one int32 accumulator of 64 rows x 256 entries:
//   A1 = [qe(p); qm(p)] rows  against  B1 = bit b of m   (0 or 1),
//   A2 = [qe(p); 0]     rows  against  B2 = bit b of pm times -2 (0 or -2),
// so the qe(p) row sums dot and the qm(p) row sums den, exactly, for any
// int8 query. Rows 16w + g hold dot(p) and 16w + 8 + g den(p) for
// p = 8w + g: wgmma gives thread (warp w, lane 4g + t) exactly those two
// rows, so the epilogue packs (den << 16) | num in registers and stores along
// entries. The design on kernel (b)'s tile loop (DB on the M side, m64n32k32)
// issued 13.1M wgmmas at 1M entries; this one 3.3M at N = 256.
// - A producer warpgroup brings each 32-byte packed slab of its block's
//   entries in by TMA (a ring of 2 slabs), keeps its entries' words in
//   registers and expands them, one bit-plane a K-step, into the B tiles of
//   a ring of kBStages: int8, K-major, core matrices of 8 entries x 16 bytes
//   (the canonical no-swizzle layout, LBO 128, SBO 256). Both the slab loads
//   and the tile stores are free of bank conflicts: a lane reads its entry's
//   32 bytes in the half order (e >> 2) & 1 first, so 8 lanes cover 32 banks.
//   Then fence.proxy.async and an arrive on the stage's full barrier.
// - The query operand (the runner's int8_operand: A1 then A2, 4 KB a K-step,
//   laid out in the order wgmma reads it) streams from L2 through a ring of
//   kAStages by bulk copies, issued kAhead K-steps ahead by the producer's
//   thread 0; optionally (MC) a 2-block cluster splits each K-step's copy and
//   multicasts both halves to both blocks.
// - CW consumer warpgroups own 256 entries each (128 int32 accumulators a
//   thread); one wgmma group stays in flight. One block an SM, so no
//   setmaxnreg: every thread of the block gets the registers ptxas asks for.
// CW = 2 (512 entries a block) and CW = 1 (256) with and without the
// multicast are its variants.
//
// b1_mma_rate_kernel: the issue rate of mma.sync m16n8k256 b1 (AND +
// popc) on register operands.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_tile.cuh"
#include "tensor_map.cuh"

namespace mpc_iris {
namespace {

constexpr int kSlabs = tile::kPlane / 32;  // 50 packed 32-byte slabs an entry and plane
constexpr int kSteps = tile::kSteps;       // 400 K-steps: 50 slabs x 8 bit-planes
constexpr int kAStep = 2 * 64 * 32;        // one K-step of the query: A1, then A2
constexpr int kBoxRows = 256;              // rows of a TMA box of the DB planes
constexpr uint32_t kLsb = tile::kLsb;

// CW: consumer warpgroups (256 entries each); MC: the query copies
// multicast across a 2-block cluster.
template <int CW, bool MC>
struct DotCfg {
  static constexpr int kEntries = 256 * CW;
  static constexpr int kThreads = 128 * (CW + 1);  // one producer warpgroup
  static constexpr int kPStages = 2;
  static constexpr int kBStages = 3;
  static constexpr int kAStages = 8;
  static constexpr int kAhead = kAStages - kBStages - 1;  // never waits on a free slot
  static constexpr int kPStage = 2 * kEntries * 32;       // pattern rows, then mask rows
  static constexpr int kBStage = 2 * kEntries * 32;       // B1, then B2
  static constexpr int kBOff = kPStages * kPStage;
  static constexpr int kAOff = kBOff + kBStages * kBStage;
  static constexpr int kBarOff = kAOff + kAStages * kAStep;
  static constexpr int kSmem = 1024 + kBarOff + 8 * 2 * (kPStages + kBStages + kAStages);
  static constexpr int kPerThread = kEntries / 128;       // entries a producer thread expands
  static_assert(kAhead >= 1 && kEntries % kBoxRows == 0, "ring depths, boxes");
};

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t x, uint32_t y, uint32_t z,
                                       uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(x), "r"(y), "r"(z),
               "r"(w)
               : "memory");
}

// Orders this thread's shared-memory accesses so far before later accesses
// of the async proxy (TMA, bulk copies, wgmma): both ways, a tile written by
// threads for wgmma and a slot read by threads before the TMA refills it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// Arrives on the mbarrier at this CTA-relative address in cluster CTA `rank`.
__device__ __forceinline__ void mbar_arrive_in(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}

// A bulk copy global -> shared written at the same offset into every CTA of
// `mask`, completing its bytes on the mbarrier at the same offset in each.
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                                    uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ int pack_num_den(int dot, int den) {
  const int num = (den - dot) >> 1;
  return static_cast<int>(static_cast<unsigned>(num) | (static_cast<unsigned>(den) << 16));
}

// grid: ceil(n_entries / kEntries) blocks (even with MC). a: int8 [400][2][64
// rows][32] in wgmma's order (the runner's int8_operand); pat_map, msk_map: TMA
// maps of the uint8 [n_entries][1600] planes; out: int32 [32][n_entries].
template <int CW, bool MC>
__global__ void __launch_bounds__(DotCfg<CW, MC>::kThreads, 1)
pk_dot_int8_kernel(const __grid_constant__ CUtensorMap pat_map,
                   const __grid_constant__ CUtensorMap msk_map, const int8_t* __restrict__ a,
                   long long n_entries, int* __restrict__ out) {
  using C = DotCfg<CW, MC>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (tile::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t p_full = base + C::kBarOff;
  const uint32_t p_empty = p_full + 8 * C::kPStages;
  const uint32_t b_full = p_empty + 8 * C::kPStages;
  const uint32_t b_empty = b_full + 8 * C::kBStages;
  const uint32_t a_full = b_empty + 8 * C::kBStages;
  const uint32_t a_empty = a_full + 8 * C::kAStages;
  const long long entry0 = static_cast<long long>(blockIdx.x) * C::kEntries;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kPStages; ++s) {
      tile::mbar_init(p_full + 8 * s, 1);
      tile::mbar_init(p_empty + 8 * s, 4);  // one arrival a producer warp
    }
    for (int s = 0; s < C::kBStages; ++s) {
      tile::mbar_init(b_full + 8 * s, 4);
      tile::mbar_init(b_empty + 8 * s, 4 * CW);  // one arrival a consumer warp
    }
    for (int s = 0; s < C::kAStages; ++s) {
      tile::mbar_init(a_full + 8 * s, 1);
      tile::mbar_init(a_empty + 8 * s, 4 * CW * (MC ? 2 : 1));  // both blocks' consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (MC) cluster_sync();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: the packed slabs in, the B tiles out
    const int pt = threadIdx.x;
    const void* pat_tm = &pat_map;
    const void* msk_tm = &msk_map;
    auto fetch_packed = [&](int jj) {
      const int ps = jj % C::kPStages;
      const uint32_t dst = base + ps * C::kPStage;
      tile::mbar_expect_tx(p_full + 8 * ps, C::kPStage);
#pragma unroll
      for (int x = 0; x < C::kEntries / kBoxRows; ++x) {
        const int y = static_cast<int>(entry0) + x * kBoxRows;
        tile::tma_load_2d(dst + x * kBoxRows * 32, pat_tm, jj * 32, y, p_full + 8 * ps);
        tile::tma_load_2d(dst + (C::kEntries + x * kBoxRows) * 32, msk_tm, jj * 32, y,
                          p_full + 8 * ps);
      }
    };
    auto fetch_a = [&](int s) {
      const int as = s % C::kAStages;
      tile::mbar_wait(a_empty + 8 * as, ((s / C::kAStages) & 1) ^ 1);
      tile::mbar_expect_tx(a_full + 8 * as, kAStep);
      const uint32_t dst = base + C::kAOff + as * kAStep;
      const int8_t* src = a + static_cast<size_t>(s) * kAStep;
      if constexpr (MC) {
        const uint32_t half = cluster_rank() * (kAStep / 2);
        bulk_copy_multicast(dst + half, src + half, kAStep / 2, a_full + 8 * as, 0x3);
      } else {
        tile::bulk_copy(dst, src, kAStep, a_full + 8 * as);
      }
    };
    if (pt == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(pat_tm))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(msk_tm))
                   : "memory");
      for (int jj = 0; jj < C::kPStages; ++jj) fetch_packed(jj);
      for (int s = 0; s < C::kAhead; ++s) fetch_a(s);
    }
    // this thread's entries e = pt + 128 j: mask words m and p & m words of
    // the slab, [j][half * 4 + word], the half read first at index 0
    uint32_t m[C::kPerThread][8];
    uint32_t pm[C::kPerThread][8];
#pragma unroll 1
    for (int jj = 0; jj < kSlabs; ++jj) {
      const int ps = jj % C::kPStages;
      tile::mbar_wait(p_full + 8 * ps, (jj / C::kPStages) & 1);
      const uint32_t slab = base + ps * C::kPStage;
#pragma unroll
      for (int j = 0; j < C::kPerThread; ++j) {
        const int e = pt + 128 * j;
        const int h0 = (e >> 2) & 1;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const uint32_t off = e * 32 + (h0 ^ x) * 16;
          const uint4 p = lds128(slab + off);
          const uint4 q = lds128(slab + C::kEntries * 32 + off);
          m[j][4 * x + 0] = q.x;
          m[j][4 * x + 1] = q.y;
          m[j][4 * x + 2] = q.z;
          m[j][4 * x + 3] = q.w;
          pm[j][4 * x + 0] = p.x & q.x;
          pm[j][4 * x + 1] = p.y & q.y;
          pm[j][4 * x + 2] = p.z & q.z;
          pm[j][4 * x + 3] = p.w & q.w;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            tile::reg_fence(m[j][4 * x + i]);
            tile::reg_fence(pm[j][4 * x + i]);
          }
        }
      }
      // the slab goes back to the TMA only after every lane's loads are done
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) tile::mbar_arrive(p_empty + 8 * ps);
      if (pt == 0 && jj + C::kPStages < kSlabs) {
        tile::mbar_wait(p_empty + 8 * ps, (jj / C::kPStages) & 1);
        fetch_packed(jj + C::kPStages);
      }
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int s = jj * 8 + b;
        if (pt == 0 && s + C::kAhead < kSteps) fetch_a(s + C::kAhead);
        const int bs = s % C::kBStages;
        tile::mbar_wait(b_empty + 8 * bs, ((s / C::kBStages) & 1) ^ 1);
        const uint32_t b1 = base + C::kBOff + bs * C::kBStage;
        const uint32_t b2 = b1 + C::kEntries * 32;
#pragma unroll
        for (int j = 0; j < C::kPerThread; ++j) {
          const int e = pt + 128 * j;
          const int h0 = (e >> 2) & 1;
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const uint32_t off = (e >> 3) * 256 + (h0 ^ x) * 128 + (e & 7) * 16;
            const int w0 = 4 * x;
            sts128(b1 + off, (m[j][w0] >> b) & kLsb, (m[j][w0 + 1] >> b) & kLsb,
                   (m[j][w0 + 2] >> b) & kLsb, (m[j][w0 + 3] >> b) & kLsb);
            sts128(b2 + off, ((pm[j][w0] >> b) & kLsb) * 0xFEu,
                   ((pm[j][w0 + 1] >> b) & kLsb) * 0xFEu, ((pm[j][w0 + 2] >> b) & kLsb) * 0xFEu,
                   ((pm[j][w0 + 3] >> b) & kLsb) * 0xFEu);
          }
        }
        // the tiles are read by wgmma (the async proxy)
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) tile::mbar_arrive(b_full + 8 * bs);
      }
    }
  } else {
    // ---- consumer warpgroups: 256 entries each, one m64n256 accumulator
    const int cw = threadIdx.x / 128 - 1;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      acc[i] = 0;
      tile::reg_fence(acc[i]);
    }
    auto release = [&](int s) {
      tile::mbar_arrive(b_empty + 8 * (s % C::kBStages));
      const uint32_t bar = a_empty + 8 * (s % C::kAStages);
      if constexpr (MC) {
        mbar_arrive_in(bar, 0);
        mbar_arrive_in(bar, 1);
      } else {
        tile::mbar_arrive(bar);
      }
    };
#pragma unroll 1
    for (int s = 0; s < kSteps; ++s) {
      const int as = s % C::kAStages;
      const int bs = s % C::kBStages;
      tile::mbar_wait(a_full + 8 * as, (s / C::kAStages) & 1);
      tile::mbar_wait(b_full + 8 * bs, (s / C::kBStages) & 1);
      const uint32_t a1 = base + C::kAOff + as * kAStep;
      const uint32_t b1 = base + C::kBOff + bs * C::kBStage + cw * 256 * 32;
      tile::wgmma_fence();
      tile::wgmma_ss<256>(acc, tile::slab_desc(a1), tile::slab_desc(b1));
      tile::wgmma_ss<256>(acc, tile::slab_desc(a1 + kAStep / 2),
                          tile::slab_desc(b1 + C::kEntries * 32));
      tile::wgmma_commit();
      // the previous step's group is done: release its stages
      tile::wgmma_wait<1>();
      if (s > 0 && lane == 0) release(s - 1);
    }
    tile::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) tile::reg_fence(acc[i]);

    // register 4c + 2h + x holds row 16w + g + 8h, entry 8c + 2t + x of the
    // warpgroup's 256: h = 0 is dot(p), h = 1 den(p), p = 8w + g
    const int w = (threadIdx.x / 32) % 4;
    const int g = lane >> 2;
    const int t = lane & 3;
    int* row = out + static_cast<size_t>(8 * w + g) * n_entries;
    const long long e0 = entry0 + cw * 256 + 2 * t;
    const bool pairs = (n_entries & 1) == 0;  // 8-byte aligned pair stores
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const long long e = e0 + 8 * c;
      const int v0 = pack_num_den(acc[4 * c], acc[4 * c + 2]);
      const int v1 = pack_num_den(acc[4 * c + 1], acc[4 * c + 3]);
      if (pairs && e + 1 < n_entries) {
        __stcs(reinterpret_cast<int2*>(row + e), make_int2(v0, v1));
      } else {
        if (e < n_entries) __stcs(row + e, v0);
        if (e + 1 < n_entries) __stcs(row + e + 1, v1);
      }
    }
  }
  // no block leaves while its cluster peer may still write into it
  if constexpr (MC) cluster_sync();
}

template <int CW, bool MC>
int launch(const void* a, const void* dp, const void* dm, long long n_entries, void* out,
           cudaStream_t stream) {
  using C = DotCfg<CW, MC>;
  CUtensorMap pat_map;
  CUtensorMap msk_map;
  if (!tma::make_map_2d(&pat_map, dp, n_entries, tile::kPlane, 32, kBoxRows,
                        CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tma::make_map_2d(&msk_map, dm, n_entries, tile::kPlane, 32, kBoxRows,
                        CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(pk_dot_int8_kernel<CW, MC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n_entries + C::kEntries - 1) / C::kEntries;
  if (MC) blocks += blocks & 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 2;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = MC ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, pk_dot_int8_kernel<CW, MC>, pat_map, msk_map,
                           static_cast<const int8_t*>(a), n_entries, static_cast<int*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// D[16 x 8] += popc(A[16 x 256 bits] & B[256 bits x 8]), int32.
__device__ __forceinline__ void mma_b1_and(int (&d)[4], const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kRateChains = 8;  // independent accumulators a warp

// frags: uint32 [32 lanes][6] (a0..a3, b0, b1), the same fragments in every
// warp; each warp runs iters x kRateChains mma.sync on them and writes its
// summed accumulators to out: int32 [warps][32 lanes][4].
__global__ void b1_mma_rate_kernel(const uint32_t* __restrict__ frags, int iters,
                                   int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4];
  uint32_t b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = frags[lane * 6 + i];
  b[0] = frags[lane * 6 + 4];
  b[1] = frags[lane * 6 + 5];
  int d[kRateChains][4] = {};
#pragma unroll 1
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < kRateChains; ++c) mma_b1_and(d[c], a, b);
  const size_t warp = static_cast<size_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int s = 0;
#pragma unroll
    for (int c = 0; c < kRateChains; ++c) s += d[c][i];
    out[(warp * 32 + lane) * 4 + i] = s;
  }
}

}  // namespace
}  // namespace mpc_iris

// variant: the int8 design at 512 entries a block (0), with the query
// multicast (1), at 256 (2), with the multicast (3). a: int8
// [400][2][64][32] (the runner's int8_operand); dp, dm: uint8
// [n_entries][1600], 16-byte aligned; out: int32 [32][n_entries]. Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for another
// variant or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int pk_dot_int8_launch(int variant, const void* a, const void* dp, const void* dm,
                                  long long n_entries, void* out, void* stream) {
  using namespace mpc_iris;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<2, false>(a, dp, dm, n_entries, out, s);
    case 1: return launch<2, true>(a, dp, dm, n_entries, out, s);
    case 2: return launch<1, false>(a, dp, dm, n_entries, out, s);
    case 3: return launch<1, true>(a, dp, dm, n_entries, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// blocks x threads (a multiple of 32) threads, iters rounds of 8 mma.sync
// b1 a warp; frags: uint32 [32][6]; out: int32 [blocks * threads / 32][32][4].
extern "C" int b1_mma_rate_launch(int blocks, int threads, int iters, const void* frags, void* out,
                                  void* stream) {
  using namespace mpc_iris;
  b1_mma_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(frags), iters, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
