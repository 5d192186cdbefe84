// Small-batch match directly over the BIT-PACKED template DB, on the int8
// tensor cores, for query groups of 2 and 4.
//
// Replaces the TPU kernel mpc_iris_tpu/ops/packed_match.py::
// match_packed_small_b (kernel body _pk_select_kernel). Per query b, the
// winner (n, d, idx) over the WHOLE DB: for each entry the exact minimum over
// the 31 rotations of n/d, ties to the earliest rotation; then the exact
// argmin over entries, ties to the lowest global index. Output int32 [3][B].
// Groups of one query (B = 1, and a remainder of one, as at B = 5) do not
// come here: the wrapper launches b1_packed.cu's pk_select_kernel for
// them, the binary design, which reads the DB once at the memory rate where
// this kernel at N = 32 ran at a quarter of it. A group of 2 with one zero
// query runs a single query here too, for comparison.
//
// What bounds it on the H100: the two int8 products, 32 x 12,800 x 2 MACs
// per (query, entry): 0.84 ms per query at 1M entries at 1,979 TOPS, against
// 1.00 ms to read the 3.2 KB per entry of packed DB once (3.35 TB/s). The
// products run on wgmma from operands unpacked in registers, the DB staged
// by bulk async copies (packed_tile.cuh, shared with the audit-spectrum
// kernel packed_fractions.cu). Blocks of one entry tile for the query groups
// are adjacent in the grid, so the tile is read from device memory once and
// from L2 for the other groups. Each block leaves one partial winner per
// query; a second tiny pass folds them (frac.cuh).
#include <cuda_runtime.h>

#include <cstdint>

#include "frac.cuh"
#include "packed_tile.cuh"

namespace mpc_iris {
namespace {

// grid: (n_tiles * n_groups); block x = tile * n_groups + group.
// qt: int8 [n_groups][400][2][N][32] query slabs (packed_tile.cuh's layout);
// dp, dm: uint8 [n_entries][1600]; nq: the real queries (the last group may
// be padded); part: int32 [3][nq][n_tiles].
template <int QG, int MT>
__global__ void __launch_bounds__(tile::kThreads, 1)
packed_match_kernel(const int8_t* __restrict__ qt, const uint8_t* __restrict__ dp,
                    const uint8_t* __restrict__ dm, long long n_entries, int n_groups, int nq,
                    int* __restrict__ part) {
  using C = tile::Cfg<QG, MT>;
  const int grp = blockIdx.x % n_groups;
  const int tl = blockIdx.x / n_groups;
  const int n_tiles = gridDim.x / n_groups;
  const long long entry0 = static_cast<long long>(tl) * C::kEntries;

  const tile::Ring<QG, MT> ring(qt + static_cast<size_t>(grp) * tile::kSteps * C::kQBytes, dp,
                                dm, n_entries, entry0);
  Frac rot[MT][QG][2];
  ring.run(rot);

  __shared__ Frac s_best[QG][tile::kThreads / 32];
  const int ct = threadIdx.x;
#pragma unroll
  for (int q = 0; q < QG; ++q) {
    Frac best = frac_pad();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long e = entry0 + tile::tile_row<MT>(mt, h);
        if (e < n_entries) {
          best = frac_select(best, Frac{rot[mt][q][h].n, rot[mt][q][h].d, static_cast<int>(e)});
        }
      }
    best = warp_select(best);
    if ((ct & 31) == 0) s_best[q][ct / 32] = best;
  }
  __syncthreads();
  if (ct < QG) {
    const int q = ct;
    Frac best = frac_pad();
#pragma unroll
    for (int w = 0; w < tile::kThreads / 32; ++w) best = frac_select(best, s_best[q][w]);
    const int qi = grp * QG + q;
    if (qi < nq) {
      const size_t plane = static_cast<size_t>(nq) * n_tiles;
      const size_t at = static_cast<size_t>(qi) * n_tiles + tl;
      part[at] = best.n;
      part[plane + at] = best.d;
      part[2 * plane + at] = best.i;
    }
  }
}

template <int QG, int MT>
int launch(const void* qt, const void* dp, const void* dm, long long n_entries, int nq,
           void* part, void* out, int out_stride, cudaStream_t s) {
  using C = tile::Cfg<QG, MT>;
  auto kernel = packed_match_kernel<QG, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = static_cast<int>((n_entries + C::kEntries - 1) / C::kEntries);
  const int n_groups = (nq + QG - 1) / QG;
  kernel<<<n_tiles * n_groups, tile::kThreads, C::kSmem, s>>>(
      static_cast<const int8_t*>(qt), static_cast<const uint8_t*>(dp),
      static_cast<const uint8_t*>(dm), n_entries, n_groups, nq, static_cast<int*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_parts_kernel<<<nq, kFoldThreads, 0, s>>>(static_cast<const int*>(part), n_tiles, nq,
                                                static_cast<int*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mpc_iris

// Entries per block for a query group of qg (2 or 4) queries; 0 for
// another qg.
extern "C" int packed_tile_entries(int qg) {
  using namespace mpc_iris::tile;
  switch (qg) {
    case 2: return Cfg<2, kMt[2]>::kEntries;
    case 4: return Cfg<4, kMt[4]>::kEntries;
    default: return 0;
  }
}

// One launch for nq queries in groups of qg (2 or 4; cudaErrorInvalidValue
// for another qg): qt int8 [ceil(nq/qg)][400][2]
// [32*qg][32] query slabs; dp, dm uint8 [n_entries][1600], 16-byte aligned;
// part int32 [3 * nq * n_tiles] scratch (n_tiles = ceil(n_entries /
// packed_tile_entries(qg))); out: int32 [3] rows of out_stride, the first
// query at column 0. Launches on `stream`; returns cudaGetLastError().
extern "C" int match_packed_small_b_launch(int qg, const void* qt, const void* dp,
                                           const void* dm, long long n_entries, int nq,
                                           void* part, void* out, int out_stride, void* stream) {
  using namespace mpc_iris;
  auto s = static_cast<cudaStream_t>(stream);
  switch (qg) {
    case 2:
      return launch<2, tile::kMt[2]>(qt, dp, dm, n_entries, nq, part, out, out_stride, s);
    case 4:
      return launch<4, tile::kMt[4]>(qt, dp, dm, n_entries, nq, part, out, out_stride, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
