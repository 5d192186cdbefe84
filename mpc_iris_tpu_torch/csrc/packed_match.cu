// Small-batch match directly over the BIT-PACKED template DB.
//
// Replaces the TPU kernel mpc_iris_tpu/ops/packed_match.py::
// match_packed_small_b (kernel body _pk_select_kernel). Per query b, the
// winner (n, d, idx) over the WHOLE DB: for each entry the exact minimum over
// the 31 rotations of n/d, ties to the earliest rotation; then the exact
// argmin over entries, ties to the lowest global index. Output int32 [3][B].
//
// Arithmetic: with the ring encoding q = m - 2*(p & m) on both sides,
//   den = popcount(qm & dm),  num = (den - dot) / 2 = popcount((qp ^ dp) & qm & dm)
// over 400 32-bit words, which is the reference's integer pair exactly
// (den - dot = 2 * #unequal). So the DB stays packed (the storage format
// itself, 3.2 KB per entry), and the query is repacked once per call into
// pattern and mask bit-planes, 32 rows per query (row 31: mask 0, invalid).
//
// What bounds it on the H100: the packed DB is read once per query from
// device memory (3.2 KB per entry), but the integer work is larger:
// 2 popcounts + 5 ALU ops per word per (row, entry) pair, i.e. 32 * 400 * 2
// popcounts per (query, entry). At B >= 1 that integer throughput, not the
// bytes, is the bound. Design: a block takes one query and a tile of
// kEntries entries and walks K in slabs of kSlab words staged in shared
// memory; each thread keeps one entry's DB words in registers for its 8 query
// rows (query words are shared-memory broadcasts). Blocks of the same tile
// for the B queries are adjacent in the grid, so the tile is read from
// device memory once and from L2 for the other queries. Each block leaves
// one partial winner; a second tiny pass folds them (frac.cuh).
#include <cuda_runtime.h>

#include <cstdint>

#include "frac.cuh"

namespace mpc_iris {
namespace {

constexpr int kWords = 400;  // 12,800 bits as little-endian 32-bit words
constexpr int kRows = 32;    // rotation rows per query, row 31 a dummy
constexpr int kEntries = 64;
constexpr int kSlab = 16;
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kEntries;
constexpr int kRowsPerThread = kRows / kGroups;
static_assert(kWords % kSlab == 0, "slabs must tile K");
static_assert(kRows % kGroups == 0, "row groups must tile the rows");

// grid: (n_tiles * batch); block x = tile * batch + b.
// qp, qm: uint32 [batch][32][400]; dp, dm: uint32 [n_entries][400];
// part: int32 [3][batch][n_tiles].
__global__ void __launch_bounds__(kThreads)
packed_part_kernel(const uint32_t* __restrict__ qp, const uint32_t* __restrict__ qm,
                   const uint32_t* __restrict__ dp, const uint32_t* __restrict__ dm,
                   long long n_entries, int batch, int* __restrict__ part) {
  const int b = blockIdx.x % batch;
  const int tile = blockIdx.x / batch;
  const int n_tiles = gridDim.x / batch;
  const int e = threadIdx.x % kEntries;
  const int g = threadIdx.x / kEntries;
  const long long entry = static_cast<long long>(tile) * kEntries + e;

  // +1 padding: column-wise stores and row-wise reads both avoid bank conflicts
  __shared__ uint32_t s_qp[kSlab][kRows + 1];
  __shared__ uint32_t s_qm[kSlab][kRows + 1];
  __shared__ uint32_t s_dp[kSlab][kEntries + 1];
  __shared__ uint32_t s_dm[kSlab][kEntries + 1];
  __shared__ Frac s_rot[kGroups][kEntries];

  const uint32_t* qp_b = qp + static_cast<size_t>(b) * kRows * kWords;
  const uint32_t* qm_b = qm + static_cast<size_t>(b) * kRows * kWords;
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
  Frac best = frac_pad();
  if (g == 0 && entry < n_entries) {
#pragma unroll
    for (int gg = 1; gg < kGroups; ++gg) rot = frac_select(rot, s_rot[gg][e]);
    best = Frac{rot.n, rot.d, static_cast<int>(entry)};
  }
  best = block_select<kThreads>(best);
  if (threadIdx.x == 0) {
    const size_t plane = static_cast<size_t>(batch) * n_tiles;
    const size_t at = static_cast<size_t>(b) * n_tiles + tile;
    part[at] = best.n;
    part[plane + at] = best.d;
    part[2 * plane + at] = best.i;
  }
}

}  // namespace
}  // namespace mpc_iris

extern "C" int match_packed_small_b_parts(long long n_entries) {
  return static_cast<int>((n_entries + mpc_iris::kEntries - 1) / mpc_iris::kEntries);
}

// qp, qm: uint32 [batch][32][400] query bit-planes; dp, dm: uint32
// [n_entries][400] packed DB planes; part: int32 [3*batch*n_tiles];
// out: int32 [3, batch]. Launches on `stream`; returns cudaGetLastError().
extern "C" int match_packed_small_b_launch(const void* qp, const void* qm,
                                           const void* dp, const void* dm,
                                           long long n_entries, int batch,
                                           void* part, void* out, void* stream) {
  using namespace mpc_iris;
  const int n_tiles = match_packed_small_b_parts(n_entries);
  auto s = static_cast<cudaStream_t>(stream);
  packed_part_kernel<<<n_tiles * batch, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(qp), static_cast<const uint32_t*>(qm),
      static_cast<const uint32_t*>(dp), static_cast<const uint32_t*>(dm),
      n_entries, batch, static_cast<int*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_parts_kernel<<<batch, kFoldThreads, 0, s>>>(
      static_cast<const int*>(part), n_tiles, batch, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
