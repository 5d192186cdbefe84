// Exact fraction selection shared by the selection kernels.
//
// A candidate is a distance n/d (int32, d == 0 means +inf) with an index.
// frac_select is decode._frac_select of the JAX package: the smaller
// fraction wins, by the exact int32 cross products n1*d2 < n2*d1 (values
// <= 12,800, so products < 2^28), and ties -- equal fractions, or both
// invalid -- keep the LOWER index. It is therefore a lexicographic minimum
// over (fraction, index), and every reduction below gives the same result
// whatever order its warps, lanes and blocks combine in.
#pragma once

#include <climits>
#include <cstdint>

namespace mpc_iris {

struct Frac {
  int n;
  int d;
  int i;
};

__device__ __forceinline__ Frac frac_pad() { return Frac{0, 0, INT_MAX}; }

__device__ __forceinline__ Frac frac_select(Frac a, Frac b) {
  // unsigned products: wrap exactly like the reference's int32 multiply
  const int p1 = static_cast<int>(static_cast<unsigned>(a.n) * static_cast<unsigned>(b.d));
  const int p2 = static_cast<int>(static_cast<unsigned>(b.n) * static_cast<unsigned>(a.d));
  const bool v1 = a.d > 0;
  const bool v2 = b.d > 0;
  const bool less = (v1 && !v2) || (v1 && v2 && p1 < p2);
  const bool greater = (v2 && !v1) || (v1 && v2 && p2 < p1);
  return (less || (!greater && a.i <= b.i)) ? a : b;
}

__device__ __forceinline__ Frac warp_select(Frac f) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    Frac o;
    o.n = __shfl_down_sync(0xffffffffu, f.n, s);
    o.d = __shfl_down_sync(0xffffffffu, f.d, s);
    o.i = __shfl_down_sync(0xffffffffu, f.i, s);
    f = frac_select(f, o);
  }
  return f;
}

// Select over the whole block; the result is valid in thread 0. Every thread
// of the block must call it.
template <int kThreads>
__device__ Frac block_select(Frac f) {
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block of whole warps");
  __shared__ Frac warp_best[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  f = warp_select(f);
  if (lane == 0) warp_best[warp] = f;
  __syncthreads();
  if (warp == 0) {
    f = lane < kThreads / 32 ? warp_best[lane] : frac_pad();
    f = warp_select(f);
  }
  return f;
}

constexpr int kFoldThreads = 256;

// Second pass: per query b, the select over its n_parts block winners.
// part: int32 [3][batch][n_parts] (n, d, idx planes); out: int32 [3] rows
// of out_stride, query b at column b.
static __global__ void __launch_bounds__(kFoldThreads)
fold_parts_kernel(const int* __restrict__ part, int n_parts, int batch,
                  int* __restrict__ out, int out_stride) {
  const int b = blockIdx.x;
  const size_t plane = static_cast<size_t>(batch) * n_parts;
  const int* row = part + static_cast<size_t>(b) * n_parts;
  Frac f = frac_pad();
  for (int k = threadIdx.x; k < n_parts; k += kFoldThreads) {
    f = frac_select(f, Frac{row[k], row[plane + k], row[2 * plane + k]});
  }
  f = block_select<kFoldThreads>(f);
  if (threadIdx.x == 0) {
    out[b] = f.n;
    out[out_stride + b] = f.d;
    out[2 * out_stride + b] = f.i;
  }
}

}  // namespace mpc_iris
