// The keyed participant's share dots with the DB regenerated inside the
// kernel: ChaCha20 (RFC 8439) on the CUDA cores fused with the two int8
// share products on the tensor cores (wgmma). No lo/hi plane reaches device
// memory.
//
// Replaces the TPU probe kernel scripts/fused_regen_probe.py::make_kernel:
// its serial body `kernel` (regenerate an n-tile's planes into scratch, then
// the products) and its software-pipelined body `kernel_interleave`
// (--interleave: regenerate tile i+1 while tile i multiplies). Per query row
// m and DB row n of the chunk [row0, row0 + n_rows) of share stream sid:
//   out[m][n] = ((q.lo + 128 sum q) + ((q.hi + 128 sum q) << 8)) mod 2^16,
// as int32 in [0, 2^16) (ops/dot.py::dot_share_batch over
// ops/chacha.py::share_planes_natural). The int32 sums are exact: |q.lo| <=
// 12,800 x 128.
//
// K runs block-major, in the share file's order k = b*32 + 2w + l (ChaCha
// block b, word w, u16 lane l): one 64-byte block is exactly one 32-byte
// int8 K-step of the lo plane and one of the hi plane, so a block is
// consumed where it is made. The wrapper permutes the query side from the
// engines' natural order to this one, once per call (the dot is invariant
// under one permutation of both operands' K axis), and lays it out in
// wgmma's shared-memory order (ops/gemm.py::wgmma_slabs).
//
// What bounds it on the H100, per 16,384-row chunk: the ChaCha20 ALU work,
// 16,384 x 400 blocks x 976 int32 operations (0.191 ms at 3.35e13/s; the
// xor and rotate instructions run on the half-width integer pipe, see
// PERF.md for the bound from the instruction mix), against the two int8
// products (2 x 248 x 16,384 x 12,800 x 2 operations, 0.105 ms at
// 1,979 TOPS, at B = 8).
//
// serial (keyed_share_dot_serial_kernel): the TPU kernel's schedule, a block
// regenerates a stage, then multiplies it; regeneration and products
// overlap across co-resident blocks.
// - A block is one warpgroup and 32 DB rows. One SS-mode wgmma (both
//   operands from shared memory) takes their lo bytes as A rows 0-31 and
//   their hi bytes as rows 32-63 (the M side), against the block's QW query
//   rows (the N side: 32, 64, 128 or 256), so lo and hi share one
//   accumulator: QW / 2 int32 registers a thread, 32 x 2 x QW a block.
//   A 16,384-row chunk is 512 blocks. At B = 1 (QW = 32, 56 registers) up
//   to 8 blocks fit an SM; at B = 8 (QW = 256: 128 accumulators, 64 KB a
//   block) two, half the register file in accumulators.
// - A stage is BPT x 4 K-steps: each thread makes BPT ChaCha blocks of one
//   row (two: counters b, b + 1 with their rounds interleaved,
//   chacha::block_x2; the B = 8 shape) and stores their lo and hi bytes
//   (byte - 128, two byte permutes a word pair) straight into wgmma's
//   canonical K-major layout (core matrices of 8 rows x 16 bytes, LBO 128,
//   SBO 256); thread 0 copies a stage's query slabs by one bulk async copy,
//   a stage ahead where two buffers fit (QB = 2).
// - The epilogue meets lo and hi through shared memory (warps 2, 3 store
//   their hi sums, warps 0, 1 add and write).
//
// pipelined (keyed_share_dot_pipe_kernel): warp-specialized. A third
// warpgroup regenerates stage s + 1 into a ring of 2 stages while the two
// consumer warpgroups run wgmma on stage s (DB fragments from padded rows
// into registers, the register-A operand; query slabs from shared memory);
// a full and an empty mbarrier per stage. Two consumer warpgroups split
// either the DB rows (WR = 2: 128 rows, QW query rows) or the query rows
// (WR = 1: 64 rows, 2 QW query rows); a batch past 256 query rows takes
// several blocks per DB tile, each regenerating the tile.
#include <cuda_runtime.h>

#include <cstdint>

#include "chacha.cuh"
#include "packed_tile.cuh"

namespace mpc_iris {
namespace {

// ------------------------------------------------------------------ serial

// QW: query rows a block (the wgmma N); BPT: ChaCha blocks a thread makes a
// stage (1, or 2 with their rounds interleaved); QB: query slab buffers (2:
// the next stage's copy is in flight during this stage).
template <int QW, int BPT, int QB>
struct SerialCfg {
  static constexpr int kThreads = 128;                   // one warpgroup
  static constexpr int kRows = 32;                       // DB rows a block
  static constexpr int kSteps = BPT * kThreads / kRows;  // K-steps (ChaCha blocks) a stage
  static constexpr int kSlab = 2 * kRows * 32;           // one K-step: lo rows, then hi rows
  static constexpr int kPlanes = kSteps * kSlab;
  static constexpr int kQBytes = kSteps * QW * 32;
  static constexpr int kBarOffset = kPlanes + QB * kQBytes;
  static constexpr int kSmem = kBarOffset + 8 * QB;
  static constexpr int kStages = chacha::kBlocksPerRow / kSteps;
  // blocks an SM, from the registers a thread needs: QW / 2 accumulators
  // and the ChaCha state (about 48 registers, 72 with two blocks interleaved)
  static constexpr int kMinBlocks = 65536 / (kThreads * (QW / 2 + (BPT == 2 ? 72 : 48)));
  static_assert(BPT == 1 || BPT == 2, "blocks a thread");
  static_assert(chacha::kBlocksPerRow % kSteps == 0, "stages tile a row");
  static_assert(QW * 128 <= kBarOffset, "the hi sums fit the stage");
  static_assert(kQBytes % 128 == 0 && kPlanes % 128 == 0, "stage alignment");
};

// Stores one ChaCha block's lo and hi K-step (u16 lanes 4c..4c+3 are words
// 2c, 2c+1: low bytes, then high bytes, each - 128) at byte `off` of the
// planes: lanes 0-15 in the core matrix at off, lanes 16-31 at off + 128.
__device__ __forceinline__ void store_step(uint8_t* lo, uint8_t* hi, int off,
                                           const uint32_t (&x)[16]) {
  uint32_t l[8];
  uint32_t h[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    l[c] = __byte_perm(x[2 * c], x[2 * c + 1], 0x6420) ^ 0x80808080u;
    h[c] = __byte_perm(x[2 * c], x[2 * c + 1], 0x7531) ^ 0x80808080u;
  }
  *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  *reinterpret_cast<uint4*>(lo + off + 128) = make_uint4(l[4], l[5], l[6], l[7]);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(hi + off + 128) = make_uint4(h[4], h[5], h[6], h[7]);
}

// grid: n_dtiles * n_qtiles; block x = dtile * n_qtiles + qtile.
// qt: int8 [n_qtiles][400][QW/8][2][8][16] query slabs in file K order
// (rows past m zero); corr: int32 [m] (128 x the query row's sum); key:
// uint32 [8]; out: int32 [m][n_rows].
template <int QW, int BPT, int QB>
__global__ void __launch_bounds__(SerialCfg<QW, BPT, QB>::kThreads,
                                  SerialCfg<QW, BPT, QB>::kMinBlocks)
keyed_share_dot_serial_kernel(const int8_t* __restrict__ qt, const int* __restrict__ corr,
                              const uint32_t* __restrict__ key, uint32_t sid, uint32_t row0,
                              int n_rows, int m, int n_qtiles, int* __restrict__ out) {
  using C = SerialCfg<QW, BPT, QB>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int qtile = blockIdx.x % n_qtiles;
  const int tile0 = blockIdx.x / n_qtiles * C::kRows;  // the tile's offset from row0
  const int8_t* q = qt + static_cast<size_t>(qtile) * C::kStages * C::kQBytes;
  const uint32_t planes = tile::smem_addr(smem);
  const uint32_t sq = planes + C::kPlanes;
  const uint32_t full = planes + C::kBarOffset;
  auto fetch = [&](int st) {  // thread 0: stage st's query slabs
    const int b = st % QB;
    tile::mbar_expect_tx(full + 8 * b, C::kQBytes);
    tile::bulk_copy(sq + b * C::kQBytes, q + static_cast<size_t>(st) * C::kQBytes, C::kQBytes,
                    full + 8 * b);
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < QB; ++b) tile::mbar_init(full + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (QB == 2) fetch(0);
  }
  __syncthreads();

  uint32_t kw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) kw[i] = key[i];
  // this thread's ChaCha blocks of a stage: row r, K-steps s0 .. s0 + BPT - 1;
  // its lo bytes go to slab row r, its hi bytes to slab row 32 + r
  const int r = threadIdx.x % C::kRows;
  const int s0 = BPT * (threadIdx.x / C::kRows);
  const int cm = (r / 8) * 256 + (r % 8) * 16;  // row r's 16 bytes of a core matrix
  uint8_t* lo = smem;
  uint8_t* hi = smem + 4 * 256;

  int acc[QW / 2];
#pragma unroll
  for (int i = 0; i < QW / 2; ++i) acc[i] = 0;

#pragma unroll 1
  for (int st = 0; st < C::kStages; ++st) {
    if (QB == 1 && threadIdx.x == 0) fetch(st);
    uint32_t in[16];
    chacha::init_state(in, kw, sid, row0, tile0 + r, static_cast<uint32_t>(st * C::kSteps + s0));
    if constexpr (BPT == 2) {
      uint32_t xa[16];
      uint32_t xb[16];
      chacha::block_x2(in, xa, xb);
      store_step(lo, hi, s0 * C::kSlab + cm, xa);
      store_step(lo, hi, (s0 + 1) * C::kSlab + cm, xb);
    } else {
      uint32_t x[16];
      chacha::block(in, x);
      store_step(lo, hi, s0 * C::kSlab + cm, x);
    }
    // the planes' stores, made by the generic proxy, visible to wgmma's reads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    tile::mbar_wait(full + 8 * (st % QB), (st / QB) & 1);
    // the other buffer was read by the last stage's products, which are done
    if (QB == 2 && threadIdx.x == 0 && st + 1 < C::kStages) fetch(st + 1);
    const uint32_t b_base = sq + (st % QB) * C::kQBytes;
#pragma unroll
    for (int i = 0; i < QW / 2; ++i) tile::reg_fence(acc[i]);
    tile::wgmma_fence();
#pragma unroll
    for (int s = 0; s < C::kSteps; ++s) {
      tile::wgmma_ss<QW>(acc, tile::slab_desc(planes + s * C::kSlab),
                         tile::slab_desc(b_base + s * QW * 32));
    }
    tile::wgmma_commit();
    tile::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < QW / 2; ++i) tile::reg_fence(acc[i]);
    __syncthreads();  // the stage is read before the next overwrites it
  }

  // accumulator register 4c + 2h + e holds slab row (16 w + g + 8h) of warp
  // w, query row 8c + 2t + e: warps 0, 1 the lo sums of DB rows 0-31, warps
  // 2, 3 the hi sums of the same rows, which they hand over through int32
  // [QW / 2][64] over the stage
  int* hi_sums = reinterpret_cast<int*>(smem);
  const int ct = threadIdx.x;
  if (ct >= 64) {
#pragma unroll
    for (int i = 0; i < QW / 2; ++i) hi_sums[i * 64 + ct - 64] = acc[i];
  }
  __syncthreads();
  if (ct >= 64) return;
  const int t = ct & 3;
  const int row = tile0 + ct / 32 * 16 + (ct & 31) / 4;
  const int q0 = qtile * QW;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = row + 8 * h;
    if (n >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < QW / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int mq = q0 + 8 * c + 2 * t + e;
        if (mq < m) {
          const int k = 4 * c + 2 * h + e;
          const uint32_t cr = static_cast<uint32_t>(corr[mq]);
          const uint32_t hv = static_cast<uint32_t>(hi_sums[k * 64 + ct]);
          const uint32_t v = static_cast<uint32_t>(acc[k]) + cr + ((hv + cr) << 8);
          out[static_cast<size_t>(mq) * n_rows + n] = static_cast<int>(v & 0xFFFFu);
        }
      }
  }
}

template <int QW, int BPT, int QB>
int launch_serial(const void* qt, const void* corr, const void* key, uint32_t sid, uint32_t row0,
                  int n_rows, int m, void* out, cudaStream_t stream) {
  using C = SerialCfg<QW, BPT, QB>;
  auto kernel = keyed_share_dot_serial_kernel<QW, BPT, QB>;
  const int n_qtiles = (m + QW - 1) / QW;
  const long long blocks =
      static_cast<long long>(n_qtiles) * ((n_rows + C::kRows - 1) / C::kRows);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, stream>>>(
      static_cast<const int8_t*>(qt), static_cast<const int*>(corr),
      static_cast<const uint32_t*>(key), sid, row0, n_rows, m, n_qtiles, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------- pipelined

constexpr int kS = 4;                          // ChaCha blocks (K-steps) per stage
constexpr int kRowBytes = kS * 32 + 16;        // padded row of a stage plane
constexpr int kStages = chacha::kBlocksPerRow / kS;  // 100 stages a row
constexpr int kConsumers = 256;                // two warpgroups run the products
constexpr int kProducers = 128;                // one warpgroup regenerates
constexpr int kRing = 2;

template <int QW, int WR>
struct Cfg {
  static constexpr int kRows = 64 * WR;             // DB rows per block
  static constexpr int kQ = WR == 1 ? 2 * QW : QW;  // query rows per block
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kQBytes = kS * kQ * 32;      // one stage of query slabs
  static constexpr int kPlane = kRows * kRowBytes;  // one stage of lo (or hi)
  static constexpr int kStage = kQBytes + 2 * kPlane;
  static constexpr int kBarOffset = kRing * kStage;
  static constexpr int kSmem = kBarOffset + 2 * kRing * 8;
  static_assert(WR == 1 || WR == 2, "DB row groups");
  static_assert(kQBytes % 128 == 0 && kStage % 128 == 0, "stage alignment");
};

// Producer thread pt of np: regenerates stage st (blocks st*kS .. +kS-1) of
// the DB tile's rows into the stage planes lo, hi [kRows][kRowBytes].
template <int kRows>
__device__ __forceinline__ void regen_stage(int st, int pt, int np, uint8_t* lo, uint8_t* hi,
                                            const uint32_t (&kw)[8], uint32_t sid,
                                            uint32_t row0, uint32_t tile0) {
#pragma unroll 1
  for (int i = pt; i < kRows * kS; i += np) {
    const int r = i % kRows;
    const int s = i / kRows;
    uint32_t in[16];
    uint32_t x[16];
    chacha::init_state(in, kw, sid, row0, tile0 + r, static_cast<uint32_t>(st * kS + s));
    chacha::block(in, x);
    // u16 lanes 4c..4c+3 are words 2c, 2c+1 (low half, then high half)
    uint32_t l[8];
    uint32_t h[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      l[c] = __byte_perm(x[2 * c], x[2 * c + 1], 0x6420) ^ 0x80808080u;
      h[c] = __byte_perm(x[2 * c], x[2 * c + 1], 0x7531) ^ 0x80808080u;
    }
    uint4* dl = reinterpret_cast<uint4*>(lo + r * kRowBytes + s * 32);
    uint4* dh = reinterpret_cast<uint4*>(hi + r * kRowBytes + s * 32);
    dl[0] = make_uint4(l[0], l[1], l[2], l[3]);
    dl[1] = make_uint4(l[4], l[5], l[6], l[7]);
    dh[0] = make_uint4(h[0], h[1], h[2], h[3]);
    dh[1] = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// Consumer thread: both products of one stage into its accumulators, then
// waits for them. lo, hi: the stage planes; sq: the stage's query slabs.
template <int QW, int WR>
__device__ __forceinline__ void mma_stage(int (&acc_lo)[QW / 2], int (&acc_hi)[QW / 2],
                                          const uint8_t* lo, const uint8_t* hi, uint32_t sq,
                                          int kq) {
  const int ct = threadIdx.x;
  const int t = ct & 3;
  const int wg = ct / 128;
  const int row = (WR == 2 ? wg * 64 : 0) + (ct / 32) % 4 * 16 + (ct & 31) / 4;
  const uint32_t q_off = (WR == 1 ? wg * QW : 0) * 32;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    // A fragment registers a0..a3: rows (g, g+8) x K (4t..4t+3,
    // 16+4t..16+4t+3) of the warp's 16 rows
    uint32_t a_lo[4];
    uint32_t a_hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = (row + 8 * (i & 1)) * kRowBytes + s * 32 + (i >> 1) * 16 + 4 * t;
      a_lo[i] = *reinterpret_cast<const uint32_t*>(lo + off);
      a_hi[i] = *reinterpret_cast<const uint32_t*>(hi + off);
      tile::reg_fence(a_lo[i]);
      tile::reg_fence(a_hi[i]);
    }
    const uint64_t desc = tile::slab_desc(sq + s * kq * 32 + q_off);
    tile::wgmma_fence();
    tile::wgmma_s8<QW>(acc_lo, a_lo, desc);
    tile::wgmma_s8<QW>(acc_hi, a_hi, desc);
    tile::wgmma_commit();
  }
  tile::wgmma_wait<0>();
}

// grid: n_dtiles * n_qtiles; block x = dtile * n_qtiles + qtile.
// qt: int8 [n_qtiles][400][kQ/8][2][8][16] query slabs in file K order
// (rows past m zero); corr: int32 [m] (128 x the query row's sum); key:
// uint32 [8]; out: int32 [m][n_rows].
template <int QW, int WR>
__global__ void __launch_bounds__(Cfg<QW, WR>::kThreads, 1)
keyed_share_dot_pipe_kernel(const int8_t* __restrict__ qt, const int* __restrict__ corr,
                            const uint32_t* __restrict__ key, uint32_t sid, uint32_t row0,
                            int n_rows, int m, int n_qtiles, int* __restrict__ out) {
  using C = Cfg<QW, WR>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int qtile = blockIdx.x % n_qtiles;
  const int tile0 = blockIdx.x / n_qtiles * C::kRows;  // the tile's offset from row0
  const int8_t* q = qt + static_cast<size_t>(qtile) * kStages * C::kQBytes;
  const uint32_t full = tile::smem_addr(smem + C::kBarOffset);
  const uint32_t empty = full + 8 * kRing;

  if (threadIdx.x == 0) {
    for (int r = 0; r < kRing; ++r) {
      // the producers' arrivals and the query copy's expect_tx
      tile::mbar_init(full + 8 * r, kProducers + 1);
      tile::mbar_init(empty + 8 * r, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const bool producer = threadIdx.x >= kConsumers;
  uint32_t kw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) kw[i] = producer ? key[i] : 0u;

  int acc_lo[QW / 2];
  int acc_hi[QW / 2];
#pragma unroll
  for (int i = 0; i < QW / 2; ++i) acc_lo[i] = acc_hi[i] = 0;

  if (producer) {
    const int pt = threadIdx.x - kConsumers;
#pragma unroll 1
    for (int st = 0; st < kStages; ++st) {
      const int slot = st % kRing;
      tile::mbar_wait(empty + 8 * slot, ((st / kRing) & 1) ^ 1);
      uint8_t* base = smem + slot * C::kStage;
      if (pt == 0) {
        tile::mbar_expect_tx(full + 8 * slot, C::kQBytes);
        tile::bulk_copy(tile::smem_addr(base), q + static_cast<size_t>(st) * C::kQBytes,
                        C::kQBytes, full + 8 * slot);
      }
      regen_stage<C::kRows>(st, pt, kProducers, base + C::kQBytes,
                            base + C::kQBytes + C::kPlane, kw, sid, row0, tile0);
      tile::mbar_arrive(full + 8 * slot);
    }
    return;
  }
#pragma unroll 1
  for (int st = 0; st < kStages; ++st) {
    const int slot = st % kRing;
    tile::mbar_wait(full + 8 * slot, (st / kRing) & 1);
    const uint8_t* base = smem + slot * C::kStage;
    mma_stage<QW, WR>(acc_lo, acc_hi, base + C::kQBytes, base + C::kQBytes + C::kPlane,
                      tile::smem_addr(base), C::kQ);
    tile::mbar_arrive(empty + 8 * slot);
  }
#pragma unroll
  for (int i = 0; i < QW / 2; ++i) {
    tile::reg_fence(acc_lo[i]);
    tile::reg_fence(acc_hi[i]);
  }

  // accumulator register 4c + 2h + e holds DB row (g + 8h), query row
  // 8c + 2t + e of the warpgroup's
  const int ct = threadIdx.x;
  const int t = ct & 3;
  const int wg = ct / 128;
  const int row = tile0 + (WR == 2 ? wg * 64 : 0) + (ct / 32) % 4 * 16 + (ct & 31) / 4;
  const int q0 = qtile * C::kQ + (WR == 1 ? wg * QW : 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = row + 8 * h;
    if (n >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < QW / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int mq = q0 + 8 * c + 2 * t + e;
        if (mq < m) {
          const int k = 4 * c + 2 * h + e;
          const uint32_t cr = static_cast<uint32_t>(corr[mq]);
          const uint32_t v = static_cast<uint32_t>(acc_lo[k]) + cr +
                             ((static_cast<uint32_t>(acc_hi[k]) + cr) << 8);
          out[static_cast<size_t>(mq) * n_rows + n] = static_cast<int>(v & 0xFFFFu);
        }
      }
  }
}

template <int QW, int WR>
int launch_pipe(const void* qt, const void* corr, const void* key, uint32_t sid, uint32_t row0,
                int n_rows, int m, void* out, cudaStream_t stream) {
  using C = Cfg<QW, WR>;
  auto kernel = keyed_share_dot_pipe_kernel<QW, WR>;
  const int n_qtiles = (m + C::kQ - 1) / C::kQ;
  const long long blocks =
      static_cast<long long>(n_qtiles) * ((n_rows + C::kRows - 1) / C::kRows);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, stream>>>(
      static_cast<const int8_t*>(qt), static_cast<const int*>(corr),
      static_cast<const uint32_t*>(key), sid, row0, n_rows, m, n_qtiles, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mpc_iris

// Both launchers: qt, the query slabs laid out for the shape (block's query
// rows a tile); corr: int32 [m]; key: uint32[8] key words on the device;
// sid: share stream id; row0: the chunk's first row mod 2^32; out: int32
// [m][n_rows]. Launch on `stream`; return cudaGetLastError()
// (cudaErrorInvalidValue for a shape not built).

// serial: (qw, bpt, qb) = (32, 1, 2), (64, 1, 2), (128, 1, 2) or (256, 2, 1):
// query rows a block, ChaCha blocks a thread, query slab buffers.
extern "C" int keyed_share_dots_serial_launch(int qw, int bpt, int qb, const void* qt,
                                              const void* corr, const void* key, uint32_t sid,
                                              uint32_t row0, int n_rows, int m, void* out,
                                              void* stream) {
  using namespace mpc_iris;
  const auto s = static_cast<cudaStream_t>(stream);
#define SERIAL(QW, BPT, QB)                                      \
  if (qw == QW && bpt == BPT && qb == QB)                        \
    return launch_serial<QW, BPT, QB>(qt, corr, key, sid, row0, n_rows, m, out, s);
  SERIAL(32, 1, 2)
  SERIAL(64, 1, 2)
  SERIAL(128, 1, 2)
  SERIAL(256, 2, 1)
#undef SERIAL
  return static_cast<int>(cudaErrorInvalidValue);
}

// pipelined: (wr, qw) = (2, 32), (2, 64), (2, 128) or (1, 128): DB row
// groups of 64, query rows a consumer warpgroup.
extern "C" int keyed_share_dots_pipe_launch(int wr, int qw, const void* qt, const void* corr,
                                            const void* key, uint32_t sid, uint32_t row0,
                                            int n_rows, int m, void* out, void* stream) {
  using namespace mpc_iris;
  const auto s = static_cast<cudaStream_t>(stream);
  if (wr == 2 && qw == 32) return launch_pipe<32, 2>(qt, corr, key, sid, row0, n_rows, m, out, s);
  if (wr == 2 && qw == 64) return launch_pipe<64, 2>(qt, corr, key, sid, row0, n_rows, m, out, s);
  if (wr == 2 && qw == 128) return launch_pipe<128, 2>(qt, corr, key, sid, row0, n_rows, m, out, s);
  if (wr == 1 && qw == 128) return launch_pipe<128, 1>(qt, corr, key, sid, row0, n_rows, m, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
