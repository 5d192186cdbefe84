// Small-batch match directly over the BIT-PACKED template DB.
//
// Replaces the TPU kernel mpc_iris_tpu/ops/packed_match.py::
// match_packed_small_b (kernel body _pk_select_kernel). Per query b, the
// winner (n, d, idx) over the WHOLE DB: for each entry the exact minimum over
// the 31 rotations of n/d, ties to the earliest rotation; then the exact
// argmin over entries, ties to the lowest global index. Output int32 [3][B].
//
// The per-entry rotation minimum is packed_tile.cuh's, shared with the
// audit-spectrum kernel (packed_fractions.cu).
//
// What bounds it on the H100: the packed DB is read once per query from
// device memory (3.2 KB per entry), but the integer work is larger:
// 2 popcounts + 5 ALU ops per word per (row, entry) pair, i.e. 32 * 400 * 2
// popcounts per (query, entry). At B >= 1 that integer throughput, not the
// bytes, is the bound. Blocks of the same tile for the B queries are
// adjacent in the grid, so the tile is read from device memory once and
// from L2 for the other queries. Each block leaves one partial winner; a
// second tiny pass folds them (frac.cuh).
#include <cuda_runtime.h>

#include <cstdint>

#include "frac.cuh"
#include "packed_tile.cuh"

namespace mpc_iris {
namespace {

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
  const long long entry = static_cast<long long>(tile) * kEntries + threadIdx.x;

  const Frac rot = packed_rotation_min(qp + static_cast<size_t>(b) * kRows * kWords,
                                       qm + static_cast<size_t>(b) * kRows * kWords,
                                       dp, dm, n_entries, tile);
  Frac best = frac_pad();
  if (threadIdx.x < kEntries && entry < n_entries) {
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
