// The B = 1 pk-dot probe kernel over the BIT-PACKED template DB, on the
// int8 tensor cores.
//
// Replaces the TPU kernel scripts/b1_kernel_probe.py::make_pk_dot. It takes
// the probe's operands as given: the query's int8 encoding and mask
// [32][12,800], rows in the bit-reversed rotation order (position p holds
// rotation bitrev5(p); row 31 is the all-zero dummy) and K in the
// bit-plane-major order (k = bit * 1600 + byte), laid out by the wrapper into
// wgmma's slabs; the DB as uint8 [N][1600] pattern and mask planes. Per
// (position p, entry e): dot and den, the two int8 products, and num =
// (den - dot) >> 1; out[p][e] = (den << 16) | num, int32 [32][N] in position
// order (the probe's epilogue runs outside, in the wrapper's pk_dot_winner).
// The probe's other kernel, make_pk_select, is kernel (b) at B = 1: its
// wrapper puts the rows back in rotation order and launches
// packed_match.cu's kernel with a group of one query.
//
// What bounds it on the H100: the 3,200 bytes of packed DB an entry, 1.00 ms
// at 1M entries at 3.35 TB/s, and the 128 bytes an entry written (0.04 ms),
// against 0.87 ms of int8 operations (32 rows x 12,800 x 2 products x 2 ops
// an entry at 1,979 TOPS). So it is bound by bytes. Design: the tile loop of
// kernel (b) (packed_tile.cuh, Ring::products) with a group of one query
// (wgmma N = 32): the DB read once as packed bytes and unpacked in registers
// straight into wgmma's A operand, 256 entries a block; each (den, num)
// accumulator pair written as one word.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed_tile.cuh"

namespace mpc_iris {
namespace {

constexpr int kMt = tile::kMt[1];  // M tiles a warpgroup for one query
using Cfg1 = tile::Cfg<1, kMt>;

// grid: ceil(n_entries / 256). qt: int8 [400][2][32][32] query slabs;
// dp, dm: uint8 [n_entries][1600]; out: int32 [32][n_entries].
__global__ void __launch_bounds__(tile::kThreads, 1)
pk_dot_kernel(const int8_t* __restrict__ qt, const uint8_t* __restrict__ dp,
              const uint8_t* __restrict__ dm, long long n_entries, int* __restrict__ out) {
  const long long entry0 = static_cast<long long>(blockIdx.x) * Cfg1::kEntries;
  const tile::Ring<1, kMt> ring(qt, dp, dm, n_entries, entry0);
  int acc_dot[kMt][Cfg1::kAcc];
  int acc_den[kMt][Cfg1::kAcc];
  ring.products(acc_dot, acc_den);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long e = entry0 + tile::tile_row<kMt>(mt, h);
      if (e >= n_entries) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int k = c * 4 + 2 * h + x;
          const unsigned den = static_cast<unsigned>(acc_den[mt][k]);
          const unsigned num = (den - static_cast<unsigned>(acc_dot[mt][k])) >> 1;
          const int p = 8 * c + 2 * t + x;
          out[static_cast<size_t>(p) * n_entries + e] = static_cast<int>(num | (den << 16));
        }
    }
}

int blocks(long long n_entries) {
  return static_cast<int>((n_entries + Cfg1::kEntries - 1) / Cfg1::kEntries);
}

}  // namespace
}  // namespace mpc_iris

// qt: int8 [400][2][32][32] query slabs (the wrapper's layout); dp, dm: uint8
// [n_entries][1600], 16-byte aligned; out: int32 [32][n_entries]. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int pk_dot_launch(const void* qt, const void* dp, const void* dm, long long n_entries,
                             void* out, void* stream) {
  using namespace mpc_iris;
  cudaError_t err = cudaFuncSetAttribute(pk_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg1::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pk_dot_kernel<<<blocks(n_entries), tile::kThreads, Cfg1::kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qt), static_cast<const uint8_t*>(dp),
      static_cast<const uint8_t*>(dm), n_entries, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
