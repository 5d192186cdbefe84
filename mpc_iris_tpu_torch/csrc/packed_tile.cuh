// The per-entry rotation minimum over the BIT-PACKED template DB on Hopper's
// int8 tensor cores, shared by the packed small-batch kernels: match
// (packed_match.cu) and the audit spectrum (packed_fractions.cu), both for
// query groups of 2 and 4. The binary B = 1 kernels (b1_packed.cu) use only
// its staging helpers (mbarriers, bulk and TMA copies, reg_fence).
//
// Replaces the tile loop of the TPU kernels mpc_iris_tpu/ops/packed_match.py::
// match_packed_small_b / fractions_packed_small_b (_acc_dots, _unpack_planes):
// per (query rotation row, entry) the two int8 products
//   dot = sum enc_q * enc_d,  den = sum m_q * m_d,  num = (den - dot) >> 1,
// with the ring encoding enc = m - 2*(p & m) in {-1, 0, 1}.
//
// What bounds it on the H100 (3.35 TB/s, 1,979 int8 TOPS dense): per query
// the products are 32 rows x 12,800 x 2 MACs per entry (1.66e15 int8 ops at
// 1M entries, 0.84 ms), against 3,200 bytes of packed DB per entry (1.00 ms
// at 1M). So B = 1 is memory-bound and B >= 2 tensor-bound. Design:
// - K is in BIT-PLANE-MAJOR order (k = bit * 1600 + byte, the TPU kernel's
//   order), so a K-step of 32 is one bit-plane of 32 packed bytes: one 32-bit
//   word of 4 packed bytes gives, for bit-plane b, the int8x4 A fragment of 4
//   consecutive K by (w >> b) & 0x01010101 (mask) and
//   mask | ((p & m) >> b & 0x01010101) * 0xFE (encoding; 0xFF = -1 per byte,
//   no carry between bytes). The DB is unpacked in registers only, straight
//   into wgmma's register-A operand; it is read as packed bytes (3.2 KB per
//   entry) and never written unpacked anywhere.
// - DB entries are the M side (64 rows per warpgroup and M tile), the query
//   rotation rows the N side (N = 32 per query, QG queries per block), read
//   by wgmma from shared memory. The wrapper lays the query out once per call
//   in exactly the shared-memory order wgmma reads (K-major, no swizzle, core
//   matrices of 8 rows x 16 bytes), one contiguous 2 x N x 32-byte slab
//   (encoding, then mask) per K-step.
// - A ring of query slabs (one bulk async copy each, cp.async.bulk) and a
//   ring of packed DB stages (64 bytes of every entry of the tile, 16-byte
//   cp.async from every thread: one bulk copy per 64-byte row was limited by
//   the copy engine's request rate) stay in flight ahead of the products,
//   their completion on mbarriers. The block is two warpgroups only: at
//   8 warps a thread may hold 255 registers, so two m64n128 int32
//   accumulators fit without serialised wgmma. Each query slab is read from
//   L2 once per block and serves its kEntries entries: a request reads
//   B x 32 x 25,600 x N_entries / kEntries bytes of query from L2.
// - Accumulators: MT x 2 products x N/2 int32 registers a thread (at most 128).
// Measured on an H100 (PERF.md): 44-47% of the int8 peak at B >= 4 (N = 128),
// 19% at B = 1 (N = 32, the groups of one query before both took the binary
// kernels of b1_packed.cu). The time follows the number of wgmma instructions;
// staging, unpacking, fences, A from registers or shared memory, the slab
// layout, the wgmma depth and the operand type (e4m3) do not move it
// (scripts/packed_tile_variants.py).
// The rotation min over a query's 32 rows, which lie along the accumulator's
// N columns, is frac_select with the row as index (ties keep the earliest
// rotation), first in each thread, then across the quad that shares a row.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "frac.cuh"

namespace mpc_iris {
namespace tile {

constexpr int kPlane = 1600;                  // packed bytes per entry and plane
constexpr int kSteps = kPlane / 32 * 8;       // 400 K-steps: 50 byte slabs x 8 bit-planes
constexpr int kDbStages = 3;
constexpr int kQStages = 16;
constexpr int kPending = 1;     // wgmma groups a warpgroup leaves in flight
constexpr int kRefillLag = 2;   // a step's slot is refilled kRefillLag steps after it
static_assert(kPending >= 1 && kRefillLag >= kPending && kRefillLag < kQStages, "ring depth");
constexpr uint32_t kLsb = 0x01010101u;

// Two warpgroups a block and nothing else: at 8 warps a thread may hold 255
// registers, which two m64n128 int32 accumulators (QG = 4) need.
constexpr int kThreads = 2 * 128;
// M tiles (64 entries) per warpgroup for a query group of QG = 2 or 4.
constexpr int kMt[5] = {0, 0, 2, 0, 1};

// QG queries per block, MT M tiles (64 entries) per warpgroup.
template <int QG, int MT>
struct Cfg {
  static constexpr int N = 32 * QG;              // wgmma N: the group's rotation rows
  static constexpr int kAcc = N / 2;             // int32 registers per product and M tile
  static constexpr int kEntries = kThreads / 128 * MT * 64;
  static constexpr int kQBytes = 2 * N * 32;     // one K-step: encoding slab, mask slab
  // packed bytes per entry and DB stage; rows padded by 16 bytes, which
  // makes the fragment word loads conflict-free
  static constexpr int kDbBytes = kEntries > 256 ? 32 : 64;
  static constexpr int kDbRow = kDbBytes + 16;
  static constexpr int kDbStage = 2 * kEntries * kDbRow;  // pattern rows, mask rows
  static_assert(kPlane % kDbBytes == 0 && kDbBytes % 32 == 0, "DB stages must tile a plane");
  static constexpr int kBarOffset = kQStages * kQBytes + kDbStages * kDbStage;
  static constexpr int kSmem = kBarOffset + 2 * (kQStages + kDbStages) * 8;
  static_assert(MT * 2 * kAcc <= 128, "accumulators must fit the register file");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `bar` with this parity. A pipeline stuck for
// 2^35 cycles (~17 s) traps: the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Bulk async copy global -> shared (16-byte aligned, a multiple of 16
// bytes); its bytes complete a transaction on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(Pending) : "memory");
}
// Pins a register's value at this point of the program: keeps the compiler
// from moving its writes past a wgmma fence or its reads before a wait.
template <typename T>
__device__ __forceinline__ void reg_fence(T& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Shared-memory matrix descriptor of one N x 32-byte query slab: K-major, no
// swizzle, core matrices of 8 rows x 16 bytes (128 contiguous bytes); LBO =
// 128 bytes between the two 16-byte K halves, SBO = 256 bytes between 8-row
// groups (CUTLASS's canonical ((8,n),(16,2)):((16,SBO),(1,LBO)) layout).
__device__ __forceinline__ uint64_t slab_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// D[64 x 32] += A[64 x 32] (s8, registers) * B[32 x 32] (s8, shared memory)
__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 32] (s8, registers) * B[32 x 64] (s8, shared memory)
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 32] (s8, registers) * B[32 x 128] (s8, shared memory)
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 32) {
    wgmma_s8_n32(d, a, b);
  } else if constexpr (N == 64) {
    wgmma_s8_n64(d, a, b);
  } else {
    static_assert(N == 128, "wgmma N of a query group: 32, 64 or 128");
    wgmma_s8_n128(d, a, b);
  }
}

// Both operands from shared memory (SS mode): the int8 wgmma is K-major on
// both sides. N = 256 holds 128 int32 accumulators a thread.
// D[64 x 32] += A[64 x 32] (s8, shared memory) * B[32 x 32] (s8, shared memory)
__device__ __forceinline__ void wgmma_ss_n32(int (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 32] (s8, shared memory) * B[32 x 64] (s8, shared memory)
__device__ __forceinline__ void wgmma_ss_n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 32] (s8, shared memory) * B[32 x 128] (s8, shared memory)
__device__ __forceinline__ void wgmma_ss_n128(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 256] += A[64 x 32] (s8, shared memory) * B[32 x 256] (s8, shared memory)
__device__ __forceinline__ void wgmma_ss_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(int (&d)[N / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, desc_a, desc_b);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, desc_a, desc_b);
  } else if constexpr (N == 128) {
    wgmma_ss_n128(d, desc_a, desc_b);
  } else {
    static_assert(N == 256, "wgmma N: 32, 64, 128 or 256");
    wgmma_ss_n256(d, desc_a, desc_b);
  }
}

// Shared-memory matrix descriptor of rows x 32 bytes of a tile stored as
// TMA writes it with 128-byte swizzle: rows of 128 bytes (one stage of K),
// 8-row atoms of 1,024 bytes (SBO), LBO unused; `addr` is the tile's
// 1,024-byte-aligned base plus 32 bytes per K-step inside the row (the
// hardware applies the swizzle to the final address).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// TMA: copies the box at (x = K byte, y = row) of the tensor map into shared
// memory at `dst`, its bytes completing a transaction on `bar`; rows past
// the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// Moves registers between warpgroups of a warp-specialized block (every
// warp of the warpgroup runs it).
template <int Regs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(Regs));
}
template <int Regs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(Regs));
}

__device__ __forceinline__ Frac quad_select(Frac f) {
#pragma unroll
  for (int s = 1; s < 4; s <<= 1) {
    const Frac o{__shfl_xor_sync(0xffffffffu, f.n, s), __shfl_xor_sync(0xffffffffu, f.d, s),
                 __shfl_xor_sync(0xffffffffu, f.i, s)};
    f = frac_select(f, o);
  }
  return f;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// The tile row (0 .. kEntries-1) of a thread's result rot[mt][.][h].
template <int MT>
__device__ __forceinline__ int tile_row(int mt, int h) {
  const int ct = threadIdx.x;
  return (ct / 128 * MT + mt) * 64 + (ct / 32) % 4 * 16 + (ct & 31) / 4 + 8 * h;
}

// One block's pipeline over its entry tile and query group, in
// Cfg<QG, MT>::kSmem bytes of dynamic shared memory: a ring of kQStages
// query slabs (thread 0 keeps up to kQStages - 1 K-steps in flight with bulk
// async copies) and a ring of kDbStages packed DB stages (every thread copies its
// share with 16-byte cp.async, kDbStages - 1 stages ahead), each stage with
// a full and an empty mbarrier. Every thread of the block runs it.
template <int QG, int MT>
struct Ring {
  using C = Cfg<QG, MT>;
  const int8_t* qt;  // this block's query group, int8 [400][2][N/8][2][8][16]
  const uint8_t* dp;
  const uint8_t* dm;
  long long entry0;  // the tile's first entry
  int valid;         // entries of the tile inside the DB
  uint8_t* s_q;
  uint8_t* s_db;
  uint32_t q_full, q_empty, d_full, d_empty;

  __device__ __forceinline__ Ring(const int8_t* qt_, const uint8_t* dp_, const uint8_t* dm_,
                                  long long n_entries, long long entry0_)
      : qt(qt_), dp(dp_), dm(dm_), entry0(entry0_) {
    extern __shared__ __align__(128) uint8_t smem[];
    s_q = smem;
    s_db = smem + kQStages * C::kQBytes;
    q_full = smem_addr(smem + C::kBarOffset);
    q_empty = q_full + 8 * kQStages;
    d_full = q_empty + 8 * kQStages;
    d_empty = d_full + 8 * kDbStages;
    const long long left = n_entries - entry0;
    valid = left < C::kEntries ? static_cast<int>(left) : C::kEntries;
  }

  // Thread 0 only: waits for K-step `step`'s slot to be free, then copies
  // the step's query slab into it.
  __device__ __forceinline__ void fetch_query(int step) const {
    const int qs = step % kQStages;
    mbar_wait(q_empty + 8 * qs, ((step / kQStages) & 1) ^ 1);
    mbar_expect_tx(q_full + 8 * qs, C::kQBytes);
    bulk_copy(smem_addr(s_q + qs * C::kQBytes), qt + static_cast<size_t>(step) * C::kQBytes,
              C::kQBytes, q_full + 8 * qs);
  }

  // Every thread: waits for DB stage js's slot to be free, then copies its
  // 16-byte pieces of the stage (bytes js*64 .. js*64+63 of every entry of
  // the tile, pattern then mask rows).
  __device__ __forceinline__ void fetch_db(int js) const {
    const int ds = js % kDbStages;
    mbar_wait(d_empty + 8 * ds, ((js / kDbStages) & 1) ^ 1);
    const uint32_t st = smem_addr(s_db + ds * C::kDbStage);
    constexpr int kPieces = C::kDbBytes / 16;
    for (int k = threadIdx.x; k < 2 * C::kEntries * kPieces; k += kThreads) {
      const int row = k / kPieces % C::kEntries;
      const int plane = k / (kPieces * C::kEntries);
      const int piece = k % kPieces;
      if (row < valid) {
        const size_t src =
            static_cast<size_t>(entry0 + row) * kPlane + js * C::kDbBytes + piece * 16;
        cp_async16(st + (plane * C::kEntries + row) * C::kDbRow + piece * 16,
                   (plane ? dm : dp) + src);
      }
    }
    cp_async_arrive(d_full + 8 * ds);
  }

  // Runs the pipeline over the tile and leaves the two int32 products in
  // acc_dot and acc_den: register k = (4q + c) * 4 + 2h + e of M tile mt
  // holds the entry at tile_row(mt, h) against query row 8c + 2t + e of the
  // group's query q (t = threadIdx.x & 3).
  __device__ __forceinline__ void products(int (&acc_dot)[MT][C::kAcc],
                                           int (&acc_den)[MT][C::kAcc]) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kQStages; ++s) {
        mbar_init(q_full + 8 * s, 1);
        mbar_init(q_empty + 8 * s, kThreads);
      }
      for (int s = 0; s < kDbStages; ++s) {
        mbar_init(d_full + 8 * s, kThreads);
        mbar_init(d_empty + 8 * s, kThreads);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int s = 0; s < kQStages - kRefillLag; ++s) fetch_query(s);
    }
    for (int js = 0; js < kDbStages - 1; ++js) fetch_db(js);

    const int t = threadIdx.x & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) acc_dot[mt][i] = acc_den[mt][i] = 0;

    int step = 0;
#pragma unroll 1
    for (int js = 0; js < kPlane / C::kDbBytes; ++js) {
      if (js + kDbStages - 1 < kPlane / C::kDbBytes) fetch_db(js + kDbStages - 1);
      const int ds = js % kDbStages;
      mbar_wait(d_full + 8 * ds, (js / kDbStages) & 1);
      const uint8_t* st = s_db + ds * C::kDbStage;
#pragma unroll
      for (int jh = 0; jh < C::kDbBytes / 32; ++jh) {
        // this thread's packed words: A fragment registers a0..a3 are rows
        // (g, g+8) x K (4t..4t+3, 16+4t..16+4t+3) of the warp's 16 rows
        uint32_t m[MT][4];
        uint32_t pm[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = tile_row<MT>(mt, i & 1);
            const int off = jh * 32 + (i >> 1) * 16 + 4 * t;
            uint32_t p = 0;
            uint32_t mm = 0;  // past the end: mask 0, never a valid distance
            if (r < valid) {
              p = *reinterpret_cast<const uint32_t*>(st + r * C::kDbRow + off);
              mm = *reinterpret_cast<const uint32_t*>(st + (C::kEntries + r) * C::kDbRow + off);
            }
            m[mt][i] = mm;
            pm[mt][i] = p & mm;
          }
        }
        if (jh == C::kDbBytes / 32 - 1) mbar_arrive(d_empty + 8 * ds);
#pragma unroll
        for (int b = 0; b < 8; ++b, ++step) {
          const int qs = step % kQStages;
          uint32_t ae[MT][4];
          uint32_t am[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              am[mt][i] = (m[mt][i] >> b) & kLsb;
              ae[mt][i] = ((pm[mt][i] >> b) & kLsb) * 0xFEu + am[mt][i];
              reg_fence(am[mt][i]);
              reg_fence(ae[mt][i]);
            }
          }
          mbar_wait(q_full + 8 * qs, (step / kQStages) & 1);
          const uint32_t slab = smem_addr(s_q + qs * C::kQBytes);
          wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            wgmma_s8<C::N>(acc_dot[mt], ae[mt], slab_desc(slab));
            wgmma_s8<C::N>(acc_den[mt], am[mt], slab_desc(slab + C::N * 32));
          }
          wgmma_commit();
          // the products of step - kPending are done: free its slab ...
          wgmma_wait<kPending>();
          if (step >= kPending) mbar_arrive(q_empty + 8 * ((step - kPending) % kQStages));
          // ... and refill the slab of step - kRefillLag, which this warpgroup
          // has freed (the other one is awaited, kRefillLag - kPending steps
          // of slack)
          if (threadIdx.x == 0 && step + kQStages - kRefillLag < kSteps) {
            fetch_query(step + kQStages - kRefillLag);
          }
          __syncwarp();
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) {
        reg_fence(acc_dot[mt][i]);
        reg_fence(acc_den[mt][i]);
      }
  }

  // Returns in rot[mt][q][h], for the entry at tile_row(mt, h) and query q
  // of the group, the exact minimum over the 32 rotation rows as
  // (n, d, row), the same in the 4 threads of a quad; row 31 (all zero)
  // gives d = 0, and an all-invalid entry (0, 0, 0).
  __device__ __forceinline__ void run(Frac (&rot)[MT][QG][2]) const {
    int acc_dot[MT][C::kAcc];
    int acc_den[MT][C::kAcc];
    products(acc_dot, acc_den);
    const int t = threadIdx.x & 3;
    // accumulator register 4c + 2h + e holds row (g + 8h), column 8c + 2t + e
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < QG; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          Frac best = frac_pad();
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = (4 * q + c) * 4 + 2 * h + e;
              const int den = acc_den[mt][k];
              best = frac_select(best, Frac{(den - acc_dot[mt][k]) >> 1, den, 8 * c + 2 * t + e});
            }
          rot[mt][q][h] = quad_select(best);
        }
  }
};

}  // namespace tile
}  // namespace mpc_iris
