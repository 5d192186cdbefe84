// Fused exact selection over one DB chunk's matmul outputs.
//
// Replaces the TPU kernel mpc_iris_tpu/ops/select_pallas.py::select_chunk
// (kernel body _select_kernel). Same public layout: dot and den are int32
// [B*32, N], row 32b+p holds rotation bitrev5(p) of query b (the reference's
// ROT_BITREV feed), row 32b+31 is a dummy with den == 0. Per query b:
//   num = (den - dot) >> 1, the exact minimum fraction over the 32 rows with
//   ties to the earliest ORIGINAL rotation, then the exact argmin over the N
//   columns with ties to the lowest global index (index_offset + column).
// Output: int32 [3][B] = (n, d, idx).
//
// What bounds it on the H100: it reads every byte of the two int32 inputs
// once (8 * B * 32 * N bytes) and does a few integer ops per element, so it
// is bound by device-memory bandwidth. Design: one thread per column walks
// the 32 rows with warp-coalesced 4-byte loads (neighbouring threads,
// neighbouring columns); each block covers kColsPerBlock columns of one query
// and leaves one partial winner; a second tiny pass folds the partials.
// Blocks run in no order, so nothing is carried between them, and every step
// compares indices (frac.cuh) instead of relying on reduction order: a
// rotation's index is bitrev5(row), a column's is its global DB index.
#include <cuda_runtime.h>

#include "frac.cuh"

namespace mpc_iris {
namespace {

constexpr int kRotPad = 32;
constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kColsPerBlock = kThreads * kColsPerThread;

__device__ __forceinline__ int bitrev5(int p) {
  return static_cast<int>(__brev(static_cast<unsigned>(p)) >> 27);
}

// grid: (n_parts, B). part: int32 [3][B][n_parts].
__global__ void __launch_bounds__(kThreads)
select_part_kernel(const int* __restrict__ dot, const int* __restrict__ den,
                   int n_cols, int index_offset, int* __restrict__ part) {
  const int b = blockIdx.y;
  const int n_parts = gridDim.x;
  const size_t base = static_cast<size_t>(b) * kRotPad * n_cols;
  Frac best = frac_pad();
#pragma unroll 1
  for (int k = 0; k < kColsPerThread; ++k) {
    const int col = blockIdx.x * kColsPerBlock + k * kThreads + threadIdx.x;
    if (col >= n_cols) break;
    Frac rot = frac_pad();
#pragma unroll
    for (int p = 0; p < kRotPad; ++p) {
      const size_t at = base + static_cast<size_t>(p) * n_cols + col;
      const int dd = den[at];
      rot = frac_select(rot, Frac{(dd - dot[at]) >> 1, dd, bitrev5(p)});
    }
    best = frac_select(best, Frac{rot.n, rot.d, index_offset + col});
  }
  best = block_select<kThreads>(best);
  if (threadIdx.x == 0) {
    const size_t plane = static_cast<size_t>(gridDim.y) * n_parts;
    const size_t at = static_cast<size_t>(b) * n_parts + blockIdx.x;
    part[at] = best.n;
    part[plane + at] = best.d;
    part[2 * plane + at] = best.i;
  }
}

}  // namespace
}  // namespace mpc_iris

extern "C" int select_chunk_parts(int n_cols) {
  return (n_cols + mpc_iris::kColsPerBlock - 1) / mpc_iris::kColsPerBlock;
}

// dot, den: int32 [batch*32, n_cols]; part: int32 [3*batch*select_chunk_parts];
// out: int32 [3, batch]. Launches on `stream`; returns cudaGetLastError().
extern "C" int select_chunk_launch(const void* dot, const void* den, int batch,
                                   int n_cols, int index_offset, void* part,
                                   void* out, void* stream) {
  using namespace mpc_iris;
  const int n_parts = select_chunk_parts(n_cols);
  auto s = static_cast<cudaStream_t>(stream);
  select_part_kernel<<<dim3(n_parts, batch), kThreads, 0, s>>>(
      static_cast<const int*>(dot), static_cast<const int*>(den), n_cols,
      index_offset, static_cast<int*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_parts_kernel<<<batch, kFoldThreads, 0, s>>>(
      static_cast<const int*>(part), n_parts, batch, static_cast<int*>(out), batch);
  return static_cast<int>(cudaGetLastError());
}
