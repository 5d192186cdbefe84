// Small-batch audit spectrum directly over the BIT-PACKED template DB.
//
// Replaces the TPU kernel mpc_iris_tpu/ops/packed_match.py::
// fractions_packed_small_b (kernel body _pk_fractions_kernel). Per query b
// and entry e, the exact minimum over the 31 rotations of n/d, ties to the
// earliest rotation (packed_tile.cuh, the same code as the match kernel in
// packed_match.cu), written as int16 planes [2][B][n_entries]: n, then d.
// Both are at most 12,800, so int16 holds them exactly. Entries past the
// true DB count are all-zero padding and report (0, 0), like an all-invalid
// entry.
//
// What bounds it on the H100: the match kernel's popcounts (32 * 400 * 2 per
// (query, entry)); the only extra work is a 4-byte write per (query,
// entry), 4 * B * N bytes, coalesced along the entry axis (the 64 threads of
// row group 0 hold 64 consecutive entries). The grid is the match kernel's:
// the blocks of one tile for the B queries are adjacent, so the tile comes
// from L2 after its first read. No second pass: there is nothing to fold.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_tile.cuh"

namespace mpc_iris {
namespace {

// grid: (n_tiles * batch); block x = tile * batch + b.
// qp, qm: uint32 [batch][32][400]; dp, dm: uint32 [n_entries][400];
// out: int16 [2][batch][n_entries].
__global__ void __launch_bounds__(kThreads)
packed_fractions_kernel(const uint32_t* __restrict__ qp, const uint32_t* __restrict__ qm,
                        const uint32_t* __restrict__ dp, const uint32_t* __restrict__ dm,
                        long long n_entries, int batch, int16_t* __restrict__ out) {
  const int b = blockIdx.x % batch;
  const int tile = blockIdx.x / batch;
  const long long entry = static_cast<long long>(tile) * kEntries + threadIdx.x;

  const Frac rot = packed_rotation_min(qp + static_cast<size_t>(b) * kRows * kWords,
                                       qm + static_cast<size_t>(b) * kRows * kWords,
                                       dp, dm, n_entries, tile);
  if (threadIdx.x < kEntries && entry < n_entries) {
    const size_t at = static_cast<size_t>(b) * n_entries + entry;
    out[at] = static_cast<int16_t>(rot.n);
    out[static_cast<size_t>(batch) * n_entries + at] = static_cast<int16_t>(rot.d);
  }
}

}  // namespace
}  // namespace mpc_iris

// qp, qm: uint32 [batch][32][400] query bit-planes; dp, dm: uint32
// [n_entries][400] packed DB planes; out: int16 [2, batch, n_entries].
// Launches on `stream`; returns cudaGetLastError().
extern "C" int fractions_packed_small_b_launch(const void* qp, const void* qm,
                                               const void* dp, const void* dm,
                                               long long n_entries, int batch,
                                               void* out, void* stream) {
  using namespace mpc_iris;
  const long long n_tiles = (n_entries + kEntries - 1) / kEntries;
  packed_fractions_kernel<<<static_cast<unsigned>(n_tiles * batch), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(qp), static_cast<const uint32_t*>(qm),
      static_cast<const uint32_t*>(dp), static_cast<const uint32_t*>(dm),
      n_entries, batch, static_cast<int16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
