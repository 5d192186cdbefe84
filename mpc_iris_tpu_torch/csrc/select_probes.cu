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
// the first operand as in the probe; the tile winners folded in tile order by
// a second pass (the trees and the fold are keep_first.cuh's, shared with
// stream_probes.cu). float32 products are __fmul_rn (nvcc contracts
// nothing into an FMA); int32 products and differences are computed
// unsigned, wrapping like the probe's int32 arithmetic.
#include <cuda_runtime.h>

#include <cstdint>

#include "keep_first.cuh"

namespace mpc_iris {
namespace {

constexpr int kMaxTile = 2048;

template <typename In, typename Carry, int kCmp, int kLanes>
int launch(const void* dot, const void* den, int batch, int n_cols, int tile_n, int off,
           void* part, void* out, cudaStream_t s) {
  const int n_tiles = n_cols / tile_n;
  const cudaError_t err =
      launch_tile_select<In, Carry, kCmp, kLanes>(dot, den, batch, n_cols, tile_n, off, part, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // out: int32 [B][3 * kLanes] (n lanes, d lanes, column lanes)
  return static_cast<int>(launch_fold<kKeepFirst, kCmp>(part, batch, n_tiles, 3, kLanes, 3,
                                                        3 * kLanes, kLanes, out, s));
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
