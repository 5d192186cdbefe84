// The keep-first selection of the probes that predate kernel (a)'s
// index-aware fix, shared by the select compare probes (select_probes.cu) and
// the morph and bisect probes (stream_probes.cu).
//
// Layout as kernel (a): dot and den [B*32][N], row 32b + r the query b's row
// r. Every step keeps its FIRST operand unless the second is strictly
// smaller, so the pairing decides which index wins an exact tie, and tile_n
// is part of the function. Per query b and tile j of tile_n columns:
// - num = (den - dot) >> 1 in the carry type (int16 wraps where den - dot >
//   32,767), then the rotation tree (r, r + half) for half = 16, 8, 4, 2, 1,
//   in registers: every index is a constant once the template recursion is
//   unrolled, so the 64 carried values never leave the register file (a
//   rolled loop over the levels spilled them to the stack, 3.7x slower);
// - the column tree of the tile, (c, c + half) for half = tile_n / 2 down to
//   1 (one winner a tile) or to 128 (128 lane winners), the column index
//   off + j * tile_n + c carried: stride-halving in shared memory, then
//   __shfl_down_sync for the last 32 slots, the lower lane the first operand
//   as in the probes;
// - the per-tile records folded by a second pass in the probe's order
//   (fold_tiles_kernel).
// int32 products, sums and differences are computed unsigned, wrapping like
// the probes' int32 arithmetic (signed overflow is undefined in C++).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "frac.cuh"

namespace mpc_iris {
namespace {

constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr int kMaxTreeTile = 8192;  // 96 KB of (n, d, column) in shared memory

enum Compare { kI32 = 0, kF32 = 1, kF32Exact = 2 };

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
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
// rows in registers.
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

// The column tree over a tile's tile_n (n, d, column) slots in shared
// memory, down to kLanes winners; writes them to out[3][kLanes] (n, d,
// column). Every thread of the block calls it, after the slots are written
// and a __syncthreads.
template <int kCmp, int kLanes, typename Carry>
__device__ __forceinline__ void column_tree(Carry* s_n, Carry* s_d, int* s_i, int tile_n,
                                            int* __restrict__ out) {
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

// Both trees of one (tile, query) a block: grid (n_tiles, B). Input rows are
// In (int32 or int16), carried as Carry; a thread per column walks its 32
// rows with coalesced loads (neighbouring threads, neighbouring columns).
// part: int32 [B][n_tiles][3][kLanes] (n, d, column). Dynamic shared
// memory: tree_smem<Carry>(tile_n) bytes.
template <typename In, typename Carry, int kCmp, int kLanes>
__global__ void __launch_bounds__(kThreads)
tile_select_kernel(const In* __restrict__ dot, const In* __restrict__ den, int n_cols,
                   int tile_n, int off, int* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char tree_smem_raw[];
  int* s_i = reinterpret_cast<int*>(tree_smem_raw);
  Carry* s_n = reinterpret_cast<Carry*>(s_i + tile_n);
  Carry* s_d = s_n + tile_n;
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
  column_tree<kCmp, kLanes>(s_n, s_d, s_i, tile_n,
                            part + (static_cast<size_t>(b) * gridDim.x + j) * 3 * kLanes);
}

template <typename Carry>
size_t tree_smem(int tile_n) {
  return static_cast<size_t>(tile_n) * (sizeof(int) + 2 * sizeof(Carry));
}

// Launches tile_select_kernel on [batch*32][n_cols] inputs (tile_n a power
// of two in [128, kMaxTreeTile] dividing n_cols); returns cudaGetLastError().
template <typename In, typename Carry, int kCmp, int kLanes>
cudaError_t launch_tile_select(const void* dot, const void* den, int batch, int n_cols,
                               int tile_n, int off, void* part, cudaStream_t s) {
  const size_t smem = tree_smem<Carry>(tile_n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(tile_select_kernel<In, Carry, kCmp, kLanes>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  tile_select_kernel<In, Carry, kCmp, kLanes><<<dim3(n_cols / tile_n, batch), kThreads, smem, s>>>(
      static_cast<const In*>(dot), static_cast<const In*>(den), n_cols, tile_n, off,
      static_cast<int*>(part));
  return cudaGetLastError();
}

// Second pass: the per-tile records of a probe folded in the probe's order,
// never with atomics. How fold_tiles_kernel folds a group's records:
enum Fold { kSum = 0, kFirst, kLast, kKeepFirst, kLaneTree };
constexpr int kFoldBlock = 128;

// part: int32 [groups][n_tiles][planes][lanes], planes 1 or 3 (n, d, index).
// Per (group g, lane l), the tiles folded: a wrapping sum, tile 0, the last
// tile, or keep-first by kCmp in tile order, from tile 0's; kLaneTree
// then selects over the 128 lanes of the group (one block a group) by
// frac_select, make3's decode._frac_select, pairing (l, l + half), and gives
// the winner to every lane. Writes out[g * s_g + k * s_k + l] for k <
// out_planes, from plane k (or plane 0 when planes is 1).
template <int kFold, int kCmp>
__global__ void __launch_bounds__(kFoldBlock)
fold_tiles_kernel(const int* __restrict__ part, int groups, int n_tiles, int planes, int lanes,
                  int out_planes, long long s_g, long long s_k, int* __restrict__ out) {
  const long long k = static_cast<long long>(blockIdx.x) * kFoldBlock + threadIdx.x;
  const bool live = k < static_cast<long long>(groups) * lanes;
  const long long g = live ? k / lanes : 0;
  const int l = static_cast<int>(k % lanes);
  const size_t rec = static_cast<size_t>(planes) * lanes;
  const int* p = part + static_cast<size_t>(g) * n_tiles * rec + l;
  int v[3] = {0, 0, 0};
  if (live) {
    if constexpr (kFold == kKeepFirst || kFold == kLaneTree) {
      v[0] = p[0];
      v[1] = p[lanes];
      v[2] = p[2 * lanes];
      for (int j = 1; j < n_tiles; ++j) {
        const int* q = p + j * rec;
        if (second_wins<kCmp>(v[0], v[1], q[0], q[lanes])) {
          v[0] = q[0];
          v[1] = q[lanes];
          v[2] = q[2 * lanes];
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c >= planes) break;
        if constexpr (kFold == kSum) {
          unsigned s = 0;
          for (int j = 0; j < n_tiles; ++j) s += static_cast<unsigned>(p[j * rec + c * lanes]);
          v[c] = static_cast<int>(s);
        } else {
          v[c] = p[(kFold == kFirst ? 0 : (n_tiles - 1) * rec) + c * lanes];
        }
      }
    }
  }
  if constexpr (kFold == kLaneTree) {  // lanes == kFoldBlock: block g is group g
    __shared__ Frac s[kFoldBlock];
    s[threadIdx.x] = Frac{v[0], v[1], v[2]};
    __syncthreads();
    for (int half = kFoldBlock / 2; half > 0; half >>= 1) {
      if (threadIdx.x < half) s[threadIdx.x] = frac_select(s[threadIdx.x], s[threadIdx.x + half]);
      __syncthreads();
    }
    v[0] = s[0].n;
    v[1] = s[0].d;
    v[2] = s[0].i;
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c < out_planes) out[g * s_g + c * s_k + l] = planes > 1 ? v[c] : v[0];
  }
}

template <int kFold, int kCmp = kI32>
cudaError_t launch_fold(const void* part, int groups, int n_tiles, int planes, int lanes,
                        int out_planes, long long s_g, long long s_k, void* out, cudaStream_t s) {
  const long long threads = static_cast<long long>(groups) * lanes;
  fold_tiles_kernel<kFold, kCmp>
      <<<static_cast<unsigned>((threads + kFoldBlock - 1) / kFoldBlock), kFoldBlock, 0, s>>>(
          static_cast<const int*>(part), groups, n_tiles, planes, lanes, out_planes, s_g, s_k,
          static_cast<int*>(out));
  return cudaGetLastError();
}


}  // namespace
}  // namespace mpc_iris
