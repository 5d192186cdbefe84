// The B = 1 kernels over the BIT-PACKED template DB, on the binary tensor
// cores: pk-dot (the products, packed per position and entry), pk-select
// (the products and the exact winner) and pk-fractions (the products and the
// audit spectrum), one tile loop for all three.
//
// Replaces the TPU kernels scripts/b1_kernel_probe.py::make_pk_dot and
// make_pk_select; pk-select is also kernel (b) (mpc_iris_tpu/ops/
// packed_match.py::_pk_select_kernel) for a group of one query: the
// wrapper of match_packed_small_b launches it for every one-query group;
// pk-fractions is kernel (c) (the same file's _pk_fractions_kernel) for a
// group of one query, which fractions_packed_small_b launches likewise.
// All take the query as an operand of packed bits (the wrappers'
// pk_dot_operand and _one_query_operand): 64 rows of 1,600 bytes, row p the
// mask bits of query row p, row 32 + p its pattern-and-mask bits, packed as
// the DB is (K in the packed byte order), and the DB as uint8 [N][1600]
// pattern and mask planes.
// - pk_dot_kernel: per (position p, entry e) out[p][e] = (den << 16) | num,
//   int32 [32][N] in position order; rows in the probe's bit-reversed
//   rotation order (its epilogue runs outside, in the wrapper's
//   pk_dot_winner).
// - pk_select_kernel: rows in rotation order (row r rotation r, row 31 the
//   all-zero dummy: den 0, never valid). Per entry the exact minimum of
//   num / den over the rows, ties to the lowest row (the earliest
//   rotation), then the exact argmin over entries, ties to the lowest
//   index, den = 0 never winning (frac.cuh): int32 [3] = (n, d, idx). It
//   writes nothing per entry.
// - pk_fractions_kernel: rows in rotation order, as pk-select. Per entry the
//   same exact minimum over the rows, the earliest rotation's (n, d) on equal
//   fractions, written as int16 n at out[e] and d at out[plane + e]; an entry
//   with no valid row (den = 0 everywhere: n = 0 there too) reports (0, 0).
//
// What bounds them on the H100: the 3,200 bytes of packed DB an entry, 1.00
// ms at 1M entries at 3.35 TB/s (pk-dot also writes 128 bytes an entry,
// 0.04 ms; pk-fractions 4, 0.001 ms), against 0.87 ms of int8 operations (32
// rows x 12,800 x 2 products x 2 ops an entry at 1,979 TOPS). So all three
// are bound by bytes.
//
// The design is binary. For a bit-valued query (qm = mask bits mq, qe =
// mq - 2 pmq with pmq its pattern-and-mask bits, as prep_query gives) and the
// DB's md, pmd = p & m:
//   den = popc(mq & md),  num = popc(mq & pmd) + popc(pmq & md) - 2 popc(pmq & pmd),
// four AND-popcount products of packed bits, with no unpack at all, on the
// binary tensor instruction mma.sync m16n8k256 b1 (1.7 SM clocks each an SM
// on an H100, as scripts/b1_packed_variants_torch.py measures it: the 52.4M
// of 1M entries take 0.34 ms). That runner also times the int8 design that
// lost to this one (scripts/b1_packed_variants.cu).
// - A 16-row m-tile holds rows 8 mt + g: the mask bits in row g, the
//   pattern-and-mask bits in row g + 8; an 8-column n-tile holds 4 entries,
//   column 2i the mask bits of entry i and 2i + 1 its pattern-and-mask bits.
//   So lane 4g + t's four accumulators are the four products of one
//   (row, entry). K runs in the packed byte order on both sides (a lane's K
//   words t and 4 + t are the slab's words 2t and 2t + 1).
// - The query, 64 rows x 1,600 bytes (rows padded to 1,632 so a fragment
//   load is two wavefronts), stays in shared memory; a producer warp brings
//   it once by a bulk copy, then 64 bytes of every entry of a 256-entry tile
//   a stage by TMA (2-D maps of the [N][1600] planes, 256-byte L2
//   promotion; rows past N arrive as zeros) through a ring of 3 stages. 8
//   consumer warps take 32 entries each and the 4 m-tiles, 128 accumulators
//   a thread; a warp loads its A fragments and B words of a slab, hands the
//   stage back (after fence.proxy.async: the TMA may refill it at once) and
//   runs 32 mma.sync. Persistent: one block an SM walks the tiles.
// - The epilogues take a tile's accumulators in registers: pk-dot packs
//   (den << 16) | num and streams it out; pk-select and pk-fractions fold
//   each n-tile at once (its 4 m-tiles in the thread, then the 8 lanes of an
//   entry by xor shuffles 4, 8, 16, the row as the index). pk-select folds
//   that into one running Frac a thread with the global entry index, and
//   after the block's last tile the 8 consumer warps (a named barrier: the
//   producer warp has returned) leave one partial a block, which
//   fold_parts_kernel folds (frac.cuh). pk-fractions keeps n-tile g's
//   result in lane 4g + t4, which is the warp's entry `lane`, and each lane
//   writes its own entry: one coalesced 64-byte store a warp and plane, no
//   shared memory, nothing carried across tiles. Every step is frac_select,
//   a lexicographic minimum over (fraction, index), so the order of the folds
//   cannot change the result.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "frac.cuh"
#include "packed_tile.cuh"
#include "tensor_map.cuh"

namespace mpc_iris {
namespace {

constexpr int kSlabs = tile::kPlane / 32;  // 50 packed 32-byte slabs an entry and plane
constexpr int kBoxRows = 256;              // rows of a TMA box of the DB planes

// Orders this thread's shared-memory accesses so far before later accesses
// of the async proxy (TMA, bulk copies): a slot read by threads before the
// TMA refills it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

// ---- the tile loop
constexpr int kWarps = 8;                    // consumer warps, 32 entries each
constexpr int kTile = kWarps * 32;           // entries a tile
constexpr int kThreads = (kWarps + 1) * 32;  // and one producer warp
constexpr int kNt = 8;                       // n8 tiles (4 entries each) a warp
constexpr int kQRow = tile::kPlane + 32;     // query row pitch: 2 wavefronts a fragment load
constexpr int kQBytes = 64 * kQRow;          // mq rows 0-31, pmq rows 32-63
// A stage holds kSlabsAStage 32-byte slabs of every entry of the tile: the
// TMA box is 64 bytes wide, which timed faster than 32 on an H100 though 4
// entries at a 64-byte pitch make the B loads 2-way bank conflicts.
constexpr int kSlabsAStage = 2;
constexpr int kStage = 2 * kTile * 32 * kSlabsAStage;  // pattern rows, then mask rows
constexpr int kStages = 3;
constexpr int kTileSteps = kSlabs / kSlabsAStage;  // stages a tile
constexpr int kBarOff = kQBytes + kStages * kStage;
constexpr int kSmem = 1024 + kBarOff + 8 * (2 * kStages + 1);
static_assert(kSlabs % kSlabsAStage == 0, "stages tile the plane");

// A tile's accumulators in a consumer lane (g, t4): registers 0-3 of
// acc[nt][mt] are popc(mq & md) = den, popc(mq & pmd), popc(pmq & md),
// popc(pmq & pmd) of query row 8 mt + g and entry 4 nt + t4 of the warp's 32.
using Acc = int[kNt][4][4];

__device__ __forceinline__ int acc_num(const int (&d)[4]) { return d[1] + d[2] - 2 * d[3]; }

// The persistent walk of the three kernels: block b takes tiles b, b + gridDim.x,
// ... of kTile entries. The producer warp loads the query once, then the
// stages, and returns false. Each consumer warp runs the products of its 32
// entries of every tile and hands each tile's accumulators to
// epi.tile(acc, t, warp, g, t4); it returns true after its last tile. Every
// thread of the block must call it, once.
template <class Epilogue>
__device__ __forceinline__ bool pk_tiles(const void* pat_tm, const void* msk_tm,
                                         const uint8_t* q, int tiles, Epilogue& epi) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (tile::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t stages = base + kQBytes;
  const uint32_t full = base + kBarOff;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t q_full = empty + 8 * kStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tile::mbar_init(full + 8 * s, 1);
      tile::mbar_init(empty + 8 * s, kWarps);  // one arrival a consumer warp
    }
    tile::mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---- producer warp: the query once, then 64 bytes of every entry a
    // stage by TMA
    if (lane == 0) {
      tile::mbar_expect_tx(q_full, kQBytes);
      tile::bulk_copy(base, q, kQBytes, q_full);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        for (int s = 0; s < kTileSteps; ++s, ++it) {
          const int slot = it % kStages;
          tile::mbar_wait(empty + 8 * slot, ((it / kStages) & 1) ^ 1);
          const uint32_t st = stages + slot * kStage;
          tile::mbar_expect_tx(full + 8 * slot, kStage);
          tile::tma_load_2d(st, pat_tm, s * 32 * kSlabsAStage, t * kTile, full + 8 * slot);
          tile::tma_load_2d(st + kStage / 2, msk_tm, s * 32 * kSlabsAStage, t * kTile,
                            full + 8 * slot);
        }
      }
    }
    return false;
  }

  // ---- consumer warps: 32 entries each, the 4 products of all 32
  // rows. Lane (g, t4): A rows g (mask bits of row 8 mt + g) and g + 8 (its
  // pattern-and-mask bits) of m-tile mt; B column g, entry 4 nt + g / 2 of
  // the warp's, its mask bits (g even) or pattern-and-mask bits (g odd); the
  // K words of its fragment registers (t4, 4 + t4) are the slab's words 2 t4
  // and 2 t4 + 1, the same on both sides.
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const uint32_t q_lane = base + g * kQRow + 8 * t4;
  const uint32_t b_lane = (32 * warp + g / 2) * 32 * kSlabsAStage + 8 * t4;
  const uint32_t keep_pat = (g & 1) ? 0u : ~0u;  // even columns: the mask bits alone
  tile::mbar_wait(q_full, 0);
  int it = 0;
#pragma unroll 1
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    Acc acc;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][mt][i] = 0;
#pragma unroll 1
    for (int s = 0; s < kTileSteps; ++s, ++it) {
      const int slot = it % kStages;
      const uint32_t st = stages + slot * kStage + b_lane;
#pragma unroll
      for (int w = 0; w < kSlabsAStage; ++w) {
        const int c = s * kSlabsAStage + w;
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const uint2 lo = lds64(q_lane + 8 * mt * kQRow + c * 32);
          const uint2 hi = lds64(q_lane + (32 + 8 * mt) * kQRow + c * 32);
          a[mt][0] = lo.x;
          a[mt][1] = hi.x;
          a[mt][2] = lo.y;
          a[mt][3] = hi.y;
        }
        if (w == 0) tile::mbar_wait(full + 8 * slot, (it / kStages) & 1);
        uint32_t b[kNt][2];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const uint2 p = lds64(st + nt * 4 * 32 * kSlabsAStage + 32 * w);
          const uint2 m = lds64(st + kStage / 2 + nt * 4 * 32 * kSlabsAStage + 32 * w);
          b[nt][0] = m.x & (p.x | keep_pat);
          b[nt][1] = m.y & (p.y | keep_pat);
          tile::reg_fence(b[nt][0]);
          tile::reg_fence(b[nt][1]);
        }
        if (w == kSlabsAStage - 1) {
          // the slot goes back to the TMA (the async proxy) only after
          // every lane's loads from it are done
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) tile::mbar_arrive(empty + 8 * slot);
        }
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_b1_and(acc[nt][mt], a[mt], b[nt]);
      }
    }
    epi.tile(acc, t, warp, g, t4);
  }
  return true;
}

// ---- pk-dot: out[p][e] = (den << 16) | num, int32 [32][n_entries]
struct DotOut {
  int* out;
  long long n_entries;

  __device__ __forceinline__ void tile(const Acc& acc, int t, int warp, int g, int t4) const {
    const long long e0 = static_cast<long long>(t) * kTile + 32 * warp + t4;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const long long e = e0 + 4 * nt;
      if (e >= n_entries) continue;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned num = static_cast<unsigned>(acc_num(acc[nt][mt]));
        __stcs(out + static_cast<size_t>(8 * mt + g) * n_entries + e,
               static_cast<int>(num | (static_cast<unsigned>(acc[nt][mt][0]) << 16)));
      }
    }
  }
};

// q: uint8 [64][kQRow] (pk_dot_operand), rows in position order.
__global__ void __launch_bounds__(kThreads, 1)
pk_dot_kernel(const __grid_constant__ CUtensorMap pat_map,
              const __grid_constant__ CUtensorMap msk_map, const uint8_t* __restrict__ q,
              long long n_entries, int tiles, int* __restrict__ out) {
  DotOut epi{out, n_entries};
  pk_tiles(&pat_map, &msk_map, q, tiles, epi);
}

// The exact rotation minimum of entry 4 nt + t4 of the warp's 32, in every
// lane 4 g' + t4: its rows 8 mt + g in this lane (the row as the index), then
// its other rows in the lanes 4 g' + t4 by xor shuffles 4, 8, 16.
__device__ __forceinline__ Frac entry_min(const Acc& acc, int nt, int g) {
  Frac f = frac_pad();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    f = frac_select(f, Frac{acc_num(acc[nt][mt]), acc[nt][mt][0], 8 * mt + g});
  }
#pragma unroll
  for (int s = 4; s < 32; s <<= 1) {
    const Frac o{__shfl_xor_sync(0xffffffffu, f.n, s), __shfl_xor_sync(0xffffffffu, f.d, s),
                 __shfl_xor_sync(0xffffffffu, f.i, s)};
    f = frac_select(f, o);
  }
  return f;
}

// ---- pk-select: the exact winner, one partial a block
struct SelectBest {
  long long n_entries;
  Frac best;  // this lane's running winner over its entries of the block's tiles

  __device__ __forceinline__ void tile(const Acc& acc, int t, int warp, int g, int t4) {
    const long long e0 = static_cast<long long>(t) * kTile + 32 * warp + t4;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const Frac f = entry_min(acc, nt, g);
      const long long e = e0 + 4 * nt;
      if (e < n_entries) best = frac_select(best, Frac{f.n, f.d, static_cast<int>(e)});
    }
  }
};

// q: uint8 [64][kQRow], rows in rotation order, row 31 and 63 zero.
// part: int32 [3][gridDim.x], the (n, d, idx) planes of the blocks' winners.
__global__ void __launch_bounds__(kThreads, 1)
pk_select_kernel(const __grid_constant__ CUtensorMap pat_map,
                 const __grid_constant__ CUtensorMap msk_map, const uint8_t* __restrict__ q,
                 long long n_entries, int tiles, int* __restrict__ part) {
  __shared__ Frac warp_best[kWarps];
  SelectBest epi{n_entries, frac_pad()};
  if (!pk_tiles(&pat_map, &msk_map, q, tiles, epi)) return;  // the producer warp
  // the consumer warps alone: a named barrier of their 256 threads
  const Frac f = warp_select(epi.best);
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x / 32] = f;
  asm volatile("bar.sync 1, %0;" ::"n"(kWarps * 32) : "memory");
  if (threadIdx.x == 0) {
    Frac b = frac_pad();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) b = frac_select(b, warp_best[w]);
    part[blockIdx.x] = b.n;
    part[gridDim.x + blockIdx.x] = b.d;
    part[2 * gridDim.x + blockIdx.x] = b.i;
  }
}

// ---- pk-fractions: per entry the exact rotation minimum, int16 n and d planes
struct SpectrumOut {
  int16_t* out;
  long long n_entries;
  long long plane;

  __device__ __forceinline__ void tile(const Acc& acc, int t, int warp, int g, int t4) const {
    // lane 4 g + t4 keeps n-tile g's entry 4 g + t4, the warp's entry `lane`
    int n = 0;
    int d = 0;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const Frac f = entry_min(acc, nt, g);
      if (nt == g) {
        n = f.n;
        d = f.d;
      }
    }
    const long long e = static_cast<long long>(t) * kTile + 32 * warp + 4 * g + t4;
    if (e < n_entries) {
      __stcs(out + e, static_cast<int16_t>(n));
      __stcs(out + plane + e, static_cast<int16_t>(d));
    }
  }
};

// q: uint8 [64][kQRow], rows in rotation order, row 31 and 63 zero.
// out: int16, entry e's n at out[e] and its d at out[plane + e].
__global__ void __launch_bounds__(kThreads, 1)
pk_fractions_kernel(const __grid_constant__ CUtensorMap pat_map,
                    const __grid_constant__ CUtensorMap msk_map, const uint8_t* __restrict__ q,
                    long long n_entries, int tiles, int16_t* __restrict__ out, long long plane) {
  SpectrumOut epi{out, n_entries, plane};
  pk_tiles(&pat_map, &msk_map, q, tiles, epi);
}

// The tensor maps of the DB planes, the persistent grid (one block an SM, at
// most one a tile) and the kernel's shared memory; returns a cudaError_t.
int setup(const void* kernel, const void* dp, const void* dm, long long n_entries,
          CUtensorMap* pat_map, CUtensorMap* msk_map, int* tiles, int* grid) {
  if (!tma::make_map_2d(pat_map, dp, n_entries, tile::kPlane, 32 * kSlabsAStage, kBoxRows,
                        CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tma::make_map_2d(msk_map, dm, n_entries, tile::kPlane, 32 * kSlabsAStage, kBoxRows,
                        CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  }
  const long long n_tiles = (n_entries + kTile - 1) / kTile;
  *tiles = static_cast<int>(n_tiles);
  *grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace mpc_iris

// q: uint8 [64][1,632] (the wrapper's pk_dot_operand); dp, dm: uint8
// [n_entries][1600], 16-byte aligned; out: int32 [32][n_entries]. Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a tensor map
// cuTensorMapEncodeTiled refuses).
extern "C" int pk_dot_launch(const void* q, const void* dp, const void* dm, long long n_entries,
                             void* out, void* stream) {
  using namespace mpc_iris;
  CUtensorMap pat_map;
  CUtensorMap msk_map;
  int tiles = 0;
  int grid = 0;
  const int err = setup(reinterpret_cast<const void*>(pk_dot_kernel), dp, dm, n_entries,
                        &pat_map, &msk_map, &tiles, &grid);
  if (err != 0) return err;
  pk_dot_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      pat_map, msk_map, static_cast<const uint8_t*>(q), n_entries, tiles,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Entries a tile of the kernels: the pk-select scratch `part` holds 3 ints
// a tile.
extern "C" int pk_tile_entries() { return mpc_iris::kTile; }

// q: uint8 [64][1,632], rows in rotation order (the wrappers' operands of one
// query); dp, dm as for pk_dot_launch; part: int32 scratch of 3 *
// ceil(n_entries / pk_tile_entries()); out: int32 [3] rows of out_stride,
// the winner (n, d, idx) at column 0. The kernel, then the fold of its
// partials, on `stream`; returns cudaGetLastError().
extern "C" int pk_select_launch(const void* q, const void* dp, const void* dm,
                                long long n_entries, void* part, void* out, int out_stride,
                                void* stream) {
  using namespace mpc_iris;
  auto s = static_cast<cudaStream_t>(stream);
  CUtensorMap pat_map;
  CUtensorMap msk_map;
  int tiles = 0;
  int grid = 0;
  const int err = setup(reinterpret_cast<const void*>(pk_select_kernel), dp, dm, n_entries,
                        &pat_map, &msk_map, &tiles, &grid);
  if (err != 0) return err;
  pk_select_kernel<<<grid, kThreads, kSmem, s>>>(pat_map, msk_map,
                                                 static_cast<const uint8_t*>(q), n_entries,
                                                 tiles, static_cast<int*>(part));
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  fold_parts_kernel<<<1, kFoldThreads, 0, s>>>(static_cast<const int*>(part), grid, 1,
                                               static_cast<int*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

// q: uint8 [64][1,632], rows in rotation order (the wrapper's operand of one
// query); dp, dm as for pk_dot_launch; out: int16, the spectrum's n plane row
// [n_entries] and its d row `plane` elements further. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int pk_fractions_launch(const void* q, const void* dp, const void* dm,
                                   long long n_entries, void* out, long long plane,
                                   void* stream) {
  using namespace mpc_iris;
  CUtensorMap pat_map;
  CUtensorMap msk_map;
  int tiles = 0;
  int grid = 0;
  const int err = setup(reinterpret_cast<const void*>(pk_fractions_kernel), dp, dm, n_entries,
                        &pat_map, &msk_map, &tiles, &grid);
  if (err != 0) return err;
  pk_fractions_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      pat_map, msk_map, static_cast<const uint8_t*>(q), n_entries, tiles,
      static_cast<int16_t*>(out), plane);
  return static_cast<int>(cudaGetLastError());
}
