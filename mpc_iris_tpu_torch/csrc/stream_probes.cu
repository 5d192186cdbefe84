// The streaming, morph and bisect probe kernels: the TPU investigation
// behind kernel (a)'s design rules, each probe cutting (a)'s selection off at
// another stage of the same stream of two int32 [B][N] inputs.
//
// Replace the TPU kernels scripts/dma_probe.py::variant (s5: the (8, 128)
// corner of every (tb, tn) block), scripts/morph_probe.py::make, make2 and
// make3 (s4: the morphs from that stream to (a)'s selection) and
// scripts/select_bisect.py::make (s3: (a) cut off stage by stage, every
// column tile overwriting the last). The arithmetic of each is the probe's,
// oddities included; ops/stream_probes.py says what each computes.
//
// What bounds them on the H100: every one reads its two inputs once (1.07 GB
// at the probes' [4,096, 32,768], 0.32 ms at 3.35 TB/s; half for the
// one-input stream) and does at most some 12 integer operations an element:
// bytes. A Pallas BlockSpec copies each whole (tb, tn) block into VMEM
// whatever the body reads, and that copy is what the probes time. So:
// - stream_kernel brings every byte of its blocks on chip: a block of
//   kThreads threads takes one 32-row slab of one column tile (a query's
//   rotation rows), and streams it row by row, kPiece columns (8 KB an
//   input) a bulk async copy (cp.async.bulk, which cannot be optimised away
//   as unused plain loads can), through a ring of kStages slots whose
//   completion is on mbarriers. Each probe reads what it needs from the ring
//   as it passes: the corner, one row or column, or lanes 0-127 of every row;
//   the rest is staged and dropped, as on the TPU.
// - The probes that use every element (the column tree to 128 lanes, the
//   whole of (a)) run keep_first.cuh's tile_select_kernel: a thread per
//   column, coalesced loads, the rotation tree in registers.
// - Both write a per-tile record; keep_first.cuh's fold_tiles_kernel folds
//   the records in the probe's order (a sum, tile 0, the last tile,
//   keep-first in tile order, and make3's index-aware lane tree), never with
//   atomics.
#include <cuda_runtime.h>

#include <cstdint>

#include "keep_first.cuh"
#include "packed_tile.cuh"

namespace mpc_iris {
namespace {

constexpr int kPiece = 2048;  // columns a bulk copy
constexpr int kPieceBytes = kPiece * 4;
constexpr int kStages = 4;    // ring slots of 1 or 2 pieces: 64 KB in flight a block
constexpr int kSlab = kRows;  // rows a block streams
constexpr int kCorner = 8;    // the TPU's (8, 128) tile
constexpr int kLanes = 128;
constexpr int kRingOffset = 128;  // the mbarriers first, then the ring

// What stream_kernel reads from the ring:
// kCornerSum   rows 0-7 (of a block of block_rows), columns 0-127 of the tile:
//              dot + den, or dot alone -> out [B / block_rows * 8][n_tiles][128]
// kBisectDma   rows 0 .. tile_b - 1 (block_rows = 32 tile_b), column 0: dot +
//              den -> out [B / 32][n_tiles][3] = (n, 0, 0) per query
// kReshape     the slab's row 0, column 0: (num, den, 0)
// kRot         column 0 of the 32 rows: the rotation tree, (n, d, 0)
// kCol         row 0, all tile_n columns: the column tree to one, (n, d, col)
// kRowSum      lanes 0-127 of every row: v = sum of num + den, (v, v, v)
//              -> out [B / 32][n_tiles][3][128]
// kRotLanes    lanes 0-127 of every row: the rotation tree, (n, d, n)
enum Kind { kCornerSum = 0, kBisectDma, kReshape, kRot, kCol, kRowSum, kRotLanes };

size_t extra_bytes(int kind, int tile_n) {
  switch (kind) {
    case kRot: return 2 * kSlab * sizeof(int);
    case kCol: return tree_smem<int>(tile_n);
    case kRotLanes: return 2 * kSlab * kLanes * sizeof(int);
    default: return 0;
  }
}

// grid (n_tiles, rows / kSlab); den may be null (the one-input stream).
template <int kKind>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const int* __restrict__ dot, const int* __restrict__ den, int n_cols,
              int block_rows, int tile_n, int off, int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char stream_smem[];
  const int n_in = den != nullptr ? 2 : 1;
  const int t = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int slab = blockIdx.y;
  const int row0 = slab * kSlab;
  const int pieces = tile_n / kPiece;
  const int total = kSlab * pieces;
  const uint32_t bar0 = tile::smem_addr(stream_smem);
  int* ring = reinterpret_cast<int*>(stream_smem + kRingOffset);
  int* extra = ring + kStages * n_in * kPiece;
  const size_t first = static_cast<size_t>(row0) * n_cols + static_cast<size_t>(t) * tile_n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) tile::mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // piece k: row k / pieces of the slab, columns (k % pieces) * kPiece on
  auto fetch = [&](int k) {
    const int slot = k % kStages;
    const uint32_t bar = bar0 + 8 * slot;
    const size_t at = first + static_cast<size_t>(k / pieces) * n_cols +
                      static_cast<size_t>(k % pieces) * kPiece;
    const uint32_t dst = tile::smem_addr(ring + slot * n_in * kPiece);
    tile::mbar_expect_tx(bar, n_in * kPieceBytes);
    tile::bulk_copy(dst, dot + at, kPieceBytes, bar);
    if (den != nullptr) tile::bulk_copy(dst + kPieceBytes, den + at, kPieceBytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages && k < total; ++k) fetch(k);
  }

  const int lane = threadIdx.x;
  const bool block_head = row0 % block_rows == 0;
  unsigned sum = 0;  // kRowSum
#pragma unroll 1
  for (int k = 0; k < total; ++k) {
    const int slot = k % kStages;
    tile::mbar_wait(bar0 + 8 * slot, (k / kStages) & 1);
    const int* sdot = ring + slot * n_in * kPiece;
    const int* sden = sdot + kPiece;  // read only where den is given
    const int r = k / pieces;
    const int p = k % pieces;
    if constexpr (kKind == kCornerSum) {
      if (block_head && r < kCorner && p == 0 && lane < kLanes) {
        int v = sdot[lane];
        if (den != nullptr) v = wrap_add(v, sden[lane]);
        const size_t row = static_cast<size_t>(row0 / block_rows) * kCorner + r;
        out[(row * n_tiles + t) * kLanes + lane] = v;
      }
    } else if constexpr (kKind == kBisectDma) {
      if (block_head && r < block_rows / kSlab && p == 0 && lane == 0) {
        int* o = out + (static_cast<size_t>(slab + r) * n_tiles + t) * 3;
        o[0] = wrap_add(sdot[0], sden[0]);
        o[1] = 0;
        o[2] = 0;
      }
    } else if constexpr (kKind == kReshape) {
      if (r == 0 && p == 0 && lane == 0) {
        int* o = out + (static_cast<size_t>(slab) * n_tiles + t) * 3;
        o[0] = numerator<int>(sden[0], sdot[0]);
        o[1] = sden[0];
        o[2] = 0;
      }
    } else if constexpr (kKind == kRot) {
      if (p == 0 && lane == 0) {
        extra[r] = numerator<int>(sden[0], sdot[0]);
        extra[kSlab + r] = sden[0];
      }
    } else if constexpr (kKind == kCol) {
      if (r == 0) {
        for (int c = lane; c < kPiece; c += kThreads) {
          const int col = p * kPiece + c;
          extra[col] = static_cast<int>(static_cast<unsigned>(off) +
                                        static_cast<unsigned>(t * tile_n + col));
          extra[tile_n + col] = numerator<int>(sden[c], sdot[c]);
          extra[2 * tile_n + col] = sden[c];
        }
      }
    } else if constexpr (kKind == kRowSum) {
      if (p == 0 && lane < kLanes) {
        sum += static_cast<unsigned>(numerator<int>(sden[lane], sdot[lane])) +
               static_cast<unsigned>(sden[lane]);
      }
    } else {  // kRotLanes
      if (p == 0 && lane < kLanes) {
        extra[r * kLanes + lane] = numerator<int>(sden[lane], sdot[lane]);
        extra[(kSlab + r) * kLanes + lane] = sden[lane];
      }
    }
    __syncthreads();  // the slot is read: refill it
    if (threadIdx.x == 0 && k + kStages < total) fetch(k + kStages);
  }

  // records of 3 planes: kRowSum and kRotLanes 128 lanes, the bisects one
  if constexpr (kKind == kRot) {
    if (lane == 0) {
      int n[kRows], d[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        n[r] = extra[r];
        d[r] = extra[kSlab + r];
      }
      rotation_tree<kRows / 2, kI32>(n, d);
      int* o = out + (static_cast<size_t>(slab) * n_tiles + t) * 3;
      o[0] = n[0];
      o[1] = d[0];
      o[2] = 0;
    }
  } else if constexpr (kKind == kCol) {
    column_tree<kI32, 1>(extra + tile_n, extra + 2 * tile_n, extra, tile_n,
                         out + (static_cast<size_t>(slab) * n_tiles + t) * 3);
  } else if constexpr (kKind == kRowSum) {
    if (lane < kLanes) {
      int* o = out + (static_cast<size_t>(slab) * n_tiles + t) * 3 * kLanes;
      o[lane] = o[kLanes + lane] = o[2 * kLanes + lane] = static_cast<int>(sum);
    }
  } else if constexpr (kKind == kRotLanes) {
    if (lane < kLanes) {
      int n[kRows], d[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        n[r] = extra[r * kLanes + lane];
        d[r] = extra[(kSlab + r) * kLanes + lane];
      }
      rotation_tree<kRows / 2, kI32>(n, d);
      int* o = out + (static_cast<size_t>(slab) * n_tiles + t) * 3 * kLanes;
      o[lane] = n[0];
      o[kLanes + lane] = d[0];
      o[2 * kLanes + lane] = n[0];
    }
  }
}

template <int kKind>
cudaError_t launch_stream(const void* dot, const void* den, int rows, int n_cols,
                          int block_rows, int tile_n, int off, void* out, cudaStream_t s) {
  const int n_in = den != nullptr ? 2 : 1;
  const size_t smem = kRingOffset + static_cast<size_t>(kStages) * n_in * kPieceBytes +
                      extra_bytes(kKind, tile_n);
  const cudaError_t err = cudaFuncSetAttribute(
      stream_kernel<kKind>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  stream_kernel<kKind><<<dim3(n_cols / tile_n, rows / kSlab), kThreads, smem, s>>>(
      static_cast<const int*>(dot), static_cast<const int*>(den), n_cols, block_rows, tile_n, off,
      static_cast<int*>(out));
  return cudaGetLastError();
}

bool tile_ok(int tile_n) {
  return tile_n >= kPiece && tile_n <= kMaxTreeTile && (tile_n & (tile_n - 1)) == 0;
}

}  // namespace
}  // namespace mpc_iris

// stream_kernel of `kind` (Kind) on dot, den int32 [rows][n_cols] (den null:
// dot alone), 16-byte aligned; rows a multiple of block_rows, block_rows of
// 32; tile_n 2,048, 4,096 or 8,192 dividing n_cols; off the column offset
// (kCol). out: as Kind says. Launches on `stream`; returns cudaGetLastError().
extern "C" int stream_probe_launch(int kind, const void* dot, const void* den, int rows,
                                   int n_cols, int block_rows, int tile_n, int off, void* out,
                                   void* stream) {
  using namespace mpc_iris;
  if (rows < kSlab || rows / kSlab > 65535 || block_rows < kSlab || block_rows % kSlab ||
      rows % block_rows || !tile_ok(tile_n) || n_cols < tile_n || n_cols % tile_n ||
      (den == nullptr && kind != kCornerSum)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
#define STREAM_KIND(K)                                                               \
  case K:                                                                            \
    err = launch_stream<K>(dot, den, rows, n_cols, block_rows, tile_n, off, out, s); \
    break;
    STREAM_KIND(kCornerSum)
    STREAM_KIND(kBisectDma)
    STREAM_KIND(kReshape)
    STREAM_KIND(kRot)
    STREAM_KIND(kCol)
    STREAM_KIND(kRowSum)
    STREAM_KIND(kRotLanes)
#undef STREAM_KIND
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// tile_select_kernel with the int32 compare on dot, den int32 [batch*32]
// [n_cols]: the rotation tree, then the column tree to `lanes` (1 or 128)
// winners per (query, tile of tile_n); part int32 [batch][n_cols / tile_n][3]
// [lanes]. tile_n 2,048, 4,096 or 8,192 dividing n_cols.
extern "C" int probe_trees_launch(int lanes, const void* dot, const void* den, int batch,
                                  int n_cols, int tile_n, int off, void* part, void* stream) {
  using namespace mpc_iris;
  if (batch < 1 || batch > 65535 || !tile_ok(tile_n) || n_cols < tile_n || n_cols % tile_n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (lanes == 1) {
    return static_cast<int>(
        launch_tile_select<int, int, kI32, 1>(dot, den, batch, n_cols, tile_n, off, part, s));
  }
  if (lanes == kLanes) {
    return static_cast<int>(
        launch_tile_select<int, int, kI32, kLanes>(dot, den, batch, n_cols, tile_n, off, part, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// fold_tiles_kernel of `fold` (Fold) over part int32 [groups][n_tiles]
// [planes][lanes] into out (see the kernel); kLaneTree needs planes 3 and
// lanes 128.
extern "C" int probe_fold_launch(int fold, const void* part, int groups, int n_tiles, int planes,
                                 int lanes, int out_planes, long long s_g, long long s_k,
                                 void* out, void* stream) {
  using namespace mpc_iris;
  if (groups < 1 || n_tiles < 1 || (planes != 1 && planes != 3) || lanes < 1 ||
      out_planes < 1 || out_planes > 3 || (fold >= kKeepFirst && planes != 3) ||
      (fold == kLaneTree && lanes != kFoldBlock)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fold) {
#define FOLD(F)                                                                            \
  case F:                                                                                  \
    err = launch_fold<F>(part, groups, n_tiles, planes, lanes, out_planes, s_g, s_k, out, s); \
    break;
    FOLD(kSum)
    FOLD(kFirst)
    FOLD(kLast)
    FOLD(kKeepFirst)
    FOLD(kLaneTree)
#undef FOLD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
