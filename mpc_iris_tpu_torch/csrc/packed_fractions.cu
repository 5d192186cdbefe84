// Small-batch audit spectrum directly over the BIT-PACKED template DB, on the
// int8 tensor cores, for query groups of 2 and 4.
//
// Replaces the TPU kernel mpc_iris_tpu/ops/packed_match.py::
// fractions_packed_small_b (kernel body _pk_fractions_kernel). Per query b
// and entry e, the exact minimum over the 31 rotations of n/d, ties to the
// earliest rotation (packed_tile.cuh, the same code as the match kernel in
// packed_match.cu), written as int16 planes [2][B][n_entries]: n, then d.
// Both are at most 12,800, so int16 holds them exactly. Entries past the
// true DB count are all-zero padding and report (0, 0), like an all-invalid
// entry. Groups of one query (B = 1, and a remainder of one, as at B = 5) do
// not come here: the wrapper launches b1_packed.cu's pk_fractions_kernel for
// them, the binary design, which reads the DB once near the memory rate
// where this kernel at N = 32 ran at a quarter of it.
//
// What bounds it on the H100: the match kernel's two int8 products (0.84 ms
// per query at 1M entries at 1,979 TOPS) against the packed DB read once
// (1.00 ms at 3.35 TB/s); the only extra traffic is a 4-byte write per
// (query, entry), 4 * B * N bytes, staged in shared memory and written
// coalesced along the entry axis. No second pass: there is nothing to fold.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_tile.cuh"

namespace mpc_iris {
namespace {

// grid: (n_tiles * n_groups); block x = tile * n_groups + group.
// qt, dp, dm, nq as in packed_match.cu; out: int16, query q's n at
// out[q * n_entries + e] and its d at out[plane + q * n_entries + e].
template <int QG, int MT>
__global__ void __launch_bounds__(tile::kThreads, 1)
packed_fractions_kernel(const int8_t* __restrict__ qt, const uint8_t* __restrict__ dp,
                        const uint8_t* __restrict__ dm, long long n_entries, int n_groups, int nq,
                        int16_t* __restrict__ out, long long plane) {
  using C = tile::Cfg<QG, MT>;
  const int grp = blockIdx.x % n_groups;
  const long long entry0 = static_cast<long long>(blockIdx.x / n_groups) * C::kEntries;

  const tile::Ring<QG, MT> ring(qt + static_cast<size_t>(grp) * tile::kSteps * C::kQBytes, dp,
                                dm, n_entries, entry0);
  Frac rot[MT][QG][2];
  ring.run(rot);

  __shared__ int16_t s_nd[2][QG][C::kEntries];
  const int ct = threadIdx.x;
  if ((ct & 3) == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < QG; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = tile::tile_row<MT>(mt, h);
          s_nd[0][q][r] = static_cast<int16_t>(rot[mt][q][h].n);
          s_nd[1][q][r] = static_cast<int16_t>(rot[mt][q][h].d);
        }
  }
  __syncthreads();
  for (int k = ct; k < QG * C::kEntries; k += tile::kThreads) {
    const int q = k / C::kEntries;
    const int r = k % C::kEntries;
    const int qi = grp * QG + q;
    const long long e = entry0 + r;
    if (qi < nq && e < n_entries) {
      const size_t at = static_cast<size_t>(qi) * n_entries + e;
      out[at] = s_nd[0][q][r];
      out[plane + at] = s_nd[1][q][r];
    }
  }
}

template <int QG, int MT>
int launch(const void* qt, const void* dp, const void* dm, long long n_entries, int nq,
           void* out, long long plane, cudaStream_t s) {
  using C = tile::Cfg<QG, MT>;
  auto kernel = packed_fractions_kernel<QG, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = (n_entries + C::kEntries - 1) / C::kEntries;
  const int n_groups = (nq + QG - 1) / QG;
  kernel<<<static_cast<unsigned>(n_tiles * n_groups), tile::kThreads, C::kSmem, s>>>(
      static_cast<const int8_t*>(qt), static_cast<const uint8_t*>(dp),
      static_cast<const uint8_t*>(dm), n_entries, n_groups, nq, static_cast<int16_t*>(out),
      plane);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mpc_iris

// One launch for nq queries in groups of qg (2 or 4; cudaErrorInvalidValue
// for another qg): qt, dp, dm as for match_packed_small_b_launch; out: int16, the first query's n plane row
// (its d row is `plane` elements further). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fractions_packed_small_b_launch(int qg, const void* qt, const void* dp,
                                               const void* dm, long long n_entries, int nq,
                                               void* out, long long plane, void* stream) {
  using namespace mpc_iris;
  auto s = static_cast<cudaStream_t>(stream);
  switch (qg) {
    case 2:
      return launch<2, tile::kMt[2]>(qt, dp, dm, n_entries, nq, out, plane, s);
    case 4:
      return launch<4, tile::kMt[4]>(qt, dp, dm, n_entries, nq, out, plane, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
