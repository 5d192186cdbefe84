// The select compare-arithmetic probe kernels: fused keep-first selection
// over int32 or int16 matmul outputs, with three compares and two carry
// types.
//
// Replace the TPU kernels scripts/select_variants.py::make_select (the
// compares sel_i32, sel_f32, sel_f32_exact) and scripts/select_i16_probe.py::
// make (the int32 tree and the int16-carrying tree). Layout as kernel (a):
// dot and den [B*32][N], row 32b + r the query b's row r. Both probes predate
// (a)'s index-aware fix: every step keeps its FIRST operand unless the second
// is strictly smaller, so the pairing decides which index wins an exact tie,
// and tile_n is part of the function. Reproduced pairing for pairing:
// - per query b and tile j of tile_n columns, num = (den - dot) >> 1 in the
//   carry type (int16 wraps where den - dot > 32,767), then the rotation tree
//   (r, r + half) for half = 16, 8, 4, 2, 1;
// - the column tree of the tile, (c, c + half) for half = tile_n / 2 down to
//   1 (select_variant, one winner a tile) or to 128 (select_lanes, 128 lane
//   winners), the column index off + j * tile_n + c carried;
// - the per-tile winners folded in tile order, from tile 0's, by a second
//   pass. sel_f32 compares rounded float32 products, which is not a strict
//   weak order (12,799/12,800 and 12,798/12,799 compare equal), so only the
//   probe's pairings and fold order give the probe's answer.
//
// What bounds it on the H100: it reads every byte of dot and den once (1.07 GB
// at the probes' shapes, 0.32 ms at 3.35 TB/s) and does some 15 integer or
// float operations an element, far below the ALU peak: bytes. Design: a block
// per (tile, query); a thread per column walks its 32 rows with coalesced loads
// (neighbouring threads, neighbouring columns) and runs the rotation tree in
// registers; the tile's (n, d, col) go to shared memory for the stride-halving
// column tree, then to __shfl_down_sync for the last 32 slots, the lower lane
// the first operand as in the probe. float32 products are __fmul_rn (nvcc
// contracts nothing into an FMA); int32 products and differences are computed
// unsigned, wrapping like the probe's int32 arithmetic.
#include <cuda_runtime.h>

#include <cstdint>

namespace mpc_iris {
namespace {

constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr int kMaxTile = 2048;
constexpr int kFoldThreads = 128;

enum Compare { kI32 = 0, kF32 = 1, kF32Exact = 2 };

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// True when (n2, d2) replaces (n1, d1): the second is valid (d > 0) and the
// first is not, or both are and the second is smaller by the compare.
template <int kCmp>
__device__ __forceinline__ bool second_wins(int n1, int d1, int n2, int d2) {
  const bool v1 = d1 > 0;
  const bool v2 = d2 > 0;
  bool smaller;
  if constexpr (kCmp == kI32) {
    smaller = wrap_mul(n2, d1) < wrap_mul(n1, d2);
  } else if constexpr (kCmp == kF32) {
    const float p1 = __fmul_rn(__int2float_rn(n1), __int2float_rn(d2));
    const float p2 = __fmul_rn(__int2float_rn(n2), __int2float_rn(d1));
    smaller = p2 < p1;
  } else {
    // d = 128 * hi + lo: every partial product exact in float32 (sel_f32_exact)
    const float n1f = __int2float_rn(n1), n2f = __int2float_rn(n2);
    const float d1f = __int2float_rn(d1), d2f = __int2float_rn(d2);
    const float d1hi = floorf(__fmul_rn(d1f, 1.0f / 128.0f));
    const float d2hi = floorf(__fmul_rn(d2f, 1.0f / 128.0f));
    const float d1lo = __fsub_rn(d1f, __fmul_rn(d1hi, 128.0f));
    const float d2lo = __fsub_rn(d2f, __fmul_rn(d2hi, 128.0f));
    const float hi = __fsub_rn(__fmul_rn(n2f, d1hi), __fmul_rn(n1f, d2hi));
    const float lo = __fsub_rn(__fmul_rn(n2f, d1lo), __fmul_rn(n1f, d2lo));
    smaller = __fadd_rn(__fmul_rn(hi, 128.0f), lo) < 0.0f;
  }
  return (v2 && !v1) || (v1 && v2 && smaller);
}

// num = (den - dot) >> 1 in the carry type, wrapping as the probe's
template <typename Carry>
__device__ __forceinline__ Carry numerator(Carry den, Carry dot) {
  if constexpr (sizeof(Carry) == 4) {
    return static_cast<int>(static_cast<unsigned>(den) - static_cast<unsigned>(dot)) >> 1;
  } else {
    return static_cast<Carry>(static_cast<Carry>(den - dot) >> 1);
  }
}

// The rotation tree's levels half = kHalf, kHalf / 2, .., 1 on a column's
// rows in registers: every index is a constant once unrolled, so the rows
// never leave the register file.
template <int kHalf, int kCmp, typename Carry>
__device__ __forceinline__ void rotation_tree(Carry (&n)[kRows], Carry (&d)[kRows]) {
#pragma unroll
  for (int r = 0; r < kHalf; ++r) {
    if (second_wins<kCmp>(n[r], d[r], n[r + kHalf], d[r + kHalf])) {
      n[r] = n[r + kHalf];
      d[r] = d[r + kHalf];
    }
  }
  if constexpr (kHalf > 1) rotation_tree<kHalf / 2, kCmp>(n, d);
}

// grid: (n_tiles, B). Input rows are In (int32 or int16), carried as Carry.
// part: int32 [B][n_tiles][3][kLanes] (n, d, column).
template <typename In, typename Carry, int kCmp, int kLanes>
__global__ void __launch_bounds__(kThreads)
tile_select_kernel(const In* __restrict__ dot, const In* __restrict__ den, int n_cols,
                   int tile_n, int off, int* __restrict__ part) {
  __shared__ Carry s_n[kMaxTile];
  __shared__ Carry s_d[kMaxTile];
  __shared__ int s_i[kMaxTile];
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * kRows * n_cols + static_cast<size_t>(j) * tile_n;
#pragma unroll 1
  for (int c = threadIdx.x; c < tile_n; c += kThreads) {
    Carry n[kRows];
    Carry d[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const size_t at = base + static_cast<size_t>(r) * n_cols + c;
      d[r] = static_cast<Carry>(den[at]);
      n[r] = numerator<Carry>(d[r], static_cast<Carry>(dot[at]));
    }
    rotation_tree<kRows / 2, kCmp>(n, d);
    s_n[c] = n[0];
    s_d[c] = d[0];
    s_i[c] = static_cast<int>(static_cast<unsigned>(off) + static_cast<unsigned>(j * tile_n + c));
  }
  __syncthreads();
  for (int half = tile_n / 2; half >= kLanes && half >= 32; half >>= 1) {
    for (int c = threadIdx.x; c < half; c += kThreads) {
      if (second_wins<kCmp>(s_n[c], s_d[c], s_n[c + half], s_d[c + half])) {
        s_n[c] = s_n[c + half];
        s_d[c] = s_d[c + half];
        s_i[c] = s_i[c + half];
      }
    }
    __syncthreads();
  }
  int* out = part + (static_cast<size_t>(b) * gridDim.x + j) * 3 * kLanes;
  if constexpr (kLanes == 1) {
    if (threadIdx.x < 32) {  // the last 32 slots, one a lane
      const int lane = threadIdx.x;
      int n = s_n[lane];
      int d = s_d[lane];
      int i = s_i[lane];
#pragma unroll
      for (int half = 16; half > 0; half >>= 1) {
        const int n2 = __shfl_down_sync(0xffffffffu, n, half);
        const int d2 = __shfl_down_sync(0xffffffffu, d, half);
        const int i2 = __shfl_down_sync(0xffffffffu, i, half);
        if (second_wins<kCmp>(n, d, n2, d2)) {
          n = n2;
          d = d2;
          i = i2;
        }
      }
      if (lane == 0) {
        out[0] = n;
        out[1] = d;
        out[2] = i;
      }
    }
  } else {
    for (int l = threadIdx.x; l < kLanes; l += kThreads) {
      out[l] = s_n[l];
      out[kLanes + l] = s_d[l];
      out[2 * kLanes + l] = s_i[l];
    }
  }
}

// Second pass: per (query, lane), the tile winners folded keep-first in
// tile order. out: int32 [B][3 * kLanes] (n lanes, d lanes, column lanes).
template <int kCmp, int kLanes>
__global__ void __launch_bounds__(kFoldThreads)
fold_tiles_kernel(const int* __restrict__ part, int n_tiles, int batch, int* __restrict__ out) {
  const int k = blockIdx.x * kFoldThreads + threadIdx.x;
  if (k >= batch * kLanes) return;
  const int b = k / kLanes;
  const int l = k % kLanes;
  const int* p = part + static_cast<size_t>(b) * n_tiles * 3 * kLanes + l;
  int n = p[0];
  int d = p[kLanes];
  int i = p[2 * kLanes];
  for (int j = 1; j < n_tiles; ++j) {
    const int* q = p + static_cast<size_t>(j) * 3 * kLanes;
    if (second_wins<kCmp>(n, d, q[0], q[kLanes])) {
      n = q[0];
      d = q[kLanes];
      i = q[2 * kLanes];
    }
  }
  int* o = out + static_cast<size_t>(b) * 3 * kLanes + l;
  o[0] = n;
  o[kLanes] = d;
  o[2 * kLanes] = i;
}

template <typename In, typename Carry, int kCmp, int kLanes>
int launch(const void* dot, const void* den, int batch, int n_cols, int tile_n, int off,
           void* part, void* out, cudaStream_t s) {
  const int n_tiles = n_cols / tile_n;
  tile_select_kernel<In, Carry, kCmp, kLanes><<<dim3(n_tiles, batch), kThreads, 0, s>>>(
      static_cast<const In*>(dot), static_cast<const In*>(den), n_cols, tile_n, off,
      static_cast<int*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int folds = batch * kLanes;
  fold_tiles_kernel<kCmp, kLanes><<<(folds + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0, s>>>(
      static_cast<const int*>(part), n_tiles, batch, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int batch, int n_cols, int tile_n) {
  return batch >= 1 && batch <= 65535 && tile_n >= 128 && tile_n <= kMaxTile &&
         (tile_n & (tile_n - 1)) == 0 && n_cols >= tile_n && n_cols % tile_n == 0;
}

}  // namespace
}  // namespace mpc_iris

// select_variants.py's make_select: compare 0 (i32), 1 (f32), 2 (f32 exact);
// dot, den int32 [batch*32][n_cols]; tile_n a power of two in [128, 2048]
// dividing n_cols; part int32 [3 * batch * n_cols / tile_n] scratch; out int32
// [batch][3] = (n, d, idx). Launches on `stream`; returns cudaGetLastError().
extern "C" int select_variant_launch(int compare, const void* dot, const void* den, int batch,
                                     int n_cols, int tile_n, int off, void* part, void* out,
                                     void* stream) {
  using namespace mpc_iris;
  if (!shape_ok(batch, n_cols, tile_n)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (compare) {
    case kI32: return launch<int, int, kI32, 1>(dot, den, batch, n_cols, tile_n, off, part, out, s);
    case kF32: return launch<int, int, kF32, 1>(dot, den, batch, n_cols, tile_n, off, part, out, s);
    case kF32Exact:
      return launch<int, int, kF32Exact, 1>(dot, den, batch, n_cols, tile_n, off, part, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// select_i16_probe.py's make: dot, den int16 [batch*32][n_cols], tile 2048,
// carried in int32 (i16_tree 0) or int16 (1); part int32 [3 * 128 * batch *
// n_cols / 2048]; out int32 [batch][384] (n, d, idx lanes).
extern "C" int select_lanes_launch(int i16_tree, const void* dot, const void* den, int batch,
                                   int n_cols, void* part, void* out, void* stream) {
  using namespace mpc_iris;
  if (!shape_ok(batch, n_cols, kMaxTile)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (i16_tree) {
    return launch<int16_t, int16_t, kI32, 128>(dot, den, batch, n_cols, kMaxTile, 0, part, out, s);
  }
  return launch<int16_t, int, kI32, 128>(dot, den, batch, n_cols, kMaxTile, 0, part, out, s);
}
