// ChaCha20 (RFC 8439, 20 rounds) share-plane generator: the keyed
// participant's DB rows regenerated on the card from the 32-byte share key.
//
// Replaces the TPU kernel mpc_iris_tpu/ops/chacha.py::_words_pallas (kernel
// body _chacha_words_kernel) together with the byte extraction of
// _share_planes_natural_pallas_jit: one kernel goes from (key, stream id s,
// row offset R0) straight to the int8 (lo, hi) planes [n_rows][12800], offset
// -128, in NATURAL K order (ops/chacha.py::k_permutation): column
// j = l*6400 + w*400 + b holds byte 0 (lo) and byte 1 (hi) of the u16 lane l
// of keystream word w of block b. The TPU's uint32 word-major intermediate
// is never written.
//
// Row r = R0 + off (off = 0..n_rows-1) is the ChaCha block sequence with
// counter b = 0..399 and nonce [s, r_lo, r_hi]: r_lo = R0 + off mod 2^32 and
// the carry r_hi = (r_lo < off), taken against the GLOBAL offset from R0
// (the tile-base bug the TPU kernel fixed; tests/test_chacha.py pins it).
//
// What bounds it on the H100: integer ALU work, about 1,000 32-bit adds,
// xors and rotates per 64-byte block (20 rounds of 4 quarter rounds x 4
// lanes x 3 ops, plus the final add and the byte extraction), against 64
// bytes written: at ~1.5e13 int32 ops/s that is ~1 TB/s of planes, a third
// of the card's memory bandwidth. The design keeps it there: one thread per
// (row, block) holds the 16-word state in registers (no shared memory), the
// rotates are single funnel shifts, and the 64 byte stores of a thread go to
// columns 400 apart, so the 32 threads of a warp (consecutive blocks of one
// row) write 32 consecutive bytes per store.
#include <cuda_runtime.h>

#include <cstdint>

#include "chacha.cuh"

namespace mpc_iris {
namespace {

constexpr int kBlocksPerRow = chacha::kBlocksPerRow;
constexpr int kCols = 2 * 16 * kBlocksPerRow;  // 12,800 u16 lanes
constexpr int kThreads = 256;

// key: uint32[8] (device); lo, hi: int8 [n_rows][12800]. Thread t covers
// row t / 400, block t % 400.
__global__ void __launch_bounds__(kThreads)
chacha_planes_kernel(const uint32_t* __restrict__ key, uint32_t sid, uint32_t row0,
                     long long n_rows, int8_t* __restrict__ lo, int8_t* __restrict__ hi) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_rows * kBlocksPerRow) return;
  const long long row = t / kBlocksPerRow;
  const uint32_t b = static_cast<uint32_t>(t - row * kBlocksPerRow);
  uint32_t kw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) kw[i] = key[i];
  uint32_t in[16];
  uint32_t x[16];
  chacha::init_state(in, kw, sid, row0, static_cast<uint32_t>(row), b);
  chacha::block(in, x);
  int8_t* lo_row = lo + row * kCols + b;
  int8_t* hi_row = hi + row * kCols + b;
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    const uint32_t v = x[w];
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const uint32_t lane = v >> (16 * l);
      const int j = l * (kCols / 2) + w * kBlocksPerRow;
      lo_row[j] = static_cast<int8_t>(static_cast<int>(lane & 0xFFu) - 128);
      hi_row[j] = static_cast<int8_t>(static_cast<int>((lane >> 8) & 0xFFu) - 128);
    }
  }
}

}  // namespace
}  // namespace mpc_iris

// key: uint32[8] key words on the device; sid: share stream id; row0: the
// first row's global index mod 2^32; lo, hi: int8 [n_rows, 12800] outputs.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int chacha_planes_launch(const void* key, uint32_t sid, uint32_t row0,
                                    long long n_rows, void* lo, void* hi, void* stream) {
  using namespace mpc_iris;
  const long long threads = n_rows * kBlocksPerRow;
  chacha_planes_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads,
                         0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), sid, row0, n_rows, static_cast<int8_t*>(lo),
      static_cast<int8_t*>(hi));
  return static_cast<int>(cudaGetLastError());
}
