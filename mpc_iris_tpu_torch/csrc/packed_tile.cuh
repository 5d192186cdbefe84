// The per-entry rotation minimum over the BIT-PACKED template DB, shared by
// the packed small-batch kernels: match (packed_match.cu) and the audit
// spectrum (packed_fractions.cu). One copy, so the two cannot drift.
//
// Arithmetic: with the ring encoding q = m - 2*(p & m) on both sides,
//   den = popcount(qm & dm),  num = (den - dot) / 2 = popcount((qp ^ dp) & qm & dm)
// over 400 32-bit words, which is the reference's integer pair exactly
// (den - dot = 2 * #unequal). So the DB stays packed (the storage format
// itself, 3.2 KB per entry), and the query is repacked once per call into
// pattern and mask bit-planes, 32 rows per query (row 31: mask 0, invalid).
//
// Layout of a block: one query and a tile of kEntries entries; it walks K in
// slabs of kSlab words staged in shared memory; each thread keeps one
// entry's DB words in registers for its kRowsPerThread query rows (query
// words are shared-memory broadcasts). The rotation min is frac_select with
// the row as index, so equal fractions keep the earliest rotation's pair.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "frac.cuh"

namespace mpc_iris {

constexpr int kWords = 400;  // 12,800 bits as little-endian 32-bit words
constexpr int kRows = 32;    // rotation rows per query, row 31 a dummy
constexpr int kEntries = 64;
constexpr int kSlab = 16;
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kEntries;
constexpr int kRowsPerThread = kRows / kGroups;
static_assert(kWords % kSlab == 0, "slabs must tile K");
static_assert(kRows % kGroups == 0, "row groups must tile the rows");

// Every thread of a kThreads block must call it. qp_b, qm_b: uint32
// [32][400] of this block's query; dp, dm: uint32 [n_entries][400]; tile:
// this block's tile of kEntries entries (past n_entries: mask 0). Returns,
// in the threads of row group 0 (threadIdx.x < kEntries), the exact minimum
// over the 31 rotations of entry tile * kEntries + threadIdx.x as
// (n, d, rotation row); an all-invalid entry gives (0, 0, 0).
static __device__ __forceinline__ Frac packed_rotation_min(
    const uint32_t* __restrict__ qp_b, const uint32_t* __restrict__ qm_b,
    const uint32_t* __restrict__ dp, const uint32_t* __restrict__ dm,
    long long n_entries, int tile) {
  const int e = threadIdx.x % kEntries;
  const int g = threadIdx.x / kEntries;

  // +1 padding: column-wise stores and row-wise reads both avoid bank conflicts
  __shared__ uint32_t s_qp[kSlab][kRows + 1];
  __shared__ uint32_t s_qm[kSlab][kRows + 1];
  __shared__ uint32_t s_dp[kSlab][kEntries + 1];
  __shared__ uint32_t s_dm[kSlab][kEntries + 1];
  __shared__ Frac s_rot[kGroups][kEntries];

  int num[kRowsPerThread] = {};
  int den[kRowsPerThread] = {};

#pragma unroll 1
  for (int w0 = 0; w0 < kWords; w0 += kSlab) {
    for (int t = threadIdx.x; t < kRows * kSlab; t += kThreads) {
      const int r = t / kSlab;
      const int w = t % kSlab;
      s_qp[w][r] = qp_b[r * kWords + w0 + w];
      s_qm[w][r] = qm_b[r * kWords + w0 + w];
    }
    for (int t = threadIdx.x; t < kEntries * kSlab; t += kThreads) {
      const int ee = t / kSlab;
      const int w = t % kSlab;
      const long long en = static_cast<long long>(tile) * kEntries + ee;
      uint32_t vp = 0;
      uint32_t vm = 0;  // past the end: mask 0, never a valid distance
      if (en < n_entries) {
        vp = dp[en * kWords + w0 + w];
        vm = dm[en * kWords + w0 + w];
      }
      s_dp[w][ee] = vp;
      s_dm[w][ee] = vm;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kSlab; ++w) {
      const uint32_t p = s_dp[w][e];
      const uint32_t m = s_dm[w][e];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = g * kRowsPerThread + j;
        const uint32_t both = m & s_qm[w][r];
        den[j] += __popc(both);
        num[j] += __popc((p ^ s_qp[w][r]) & both);
      }
    }
    __syncthreads();
  }

  // rotation min per entry: this thread's rows, then across the row groups
  Frac rot = frac_pad();
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    rot = frac_select(rot, Frac{num[j], den[j], g * kRowsPerThread + j});
  }
  s_rot[g][e] = rot;
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int gg = 1; gg < kGroups; ++gg) rot = frac_select(rot, s_rot[gg][e]);
  }
  return rot;
}

}  // namespace mpc_iris
