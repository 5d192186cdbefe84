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

namespace mpc_iris {
namespace {

constexpr int kBlocksPerRow = 400;           // 400 x 64 bytes = one 25,600-byte row
constexpr int kCols = 2 * 16 * kBlocksPerRow;  // 12,800 u16 lanes
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) {
  return __funnelshift_l(x, x, k);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

// key: uint32[8] (device); lo, hi: int8 [n_rows][12800]. Thread t covers
// row t / 400, block t % 400.
__global__ void __launch_bounds__(kThreads)
chacha_planes_kernel(const uint32_t* __restrict__ key, uint32_t sid, uint32_t row0,
                     long long n_rows, int8_t* __restrict__ lo, int8_t* __restrict__ hi) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_rows * kBlocksPerRow) return;
  const long long row = t / kBlocksPerRow;
  const uint32_t b = static_cast<uint32_t>(t - row * kBlocksPerRow);
  const uint32_t off = static_cast<uint32_t>(row);
  const uint32_t rows = row0 + off;
  const uint32_t carry = rows < off ? 1u : 0u;

  uint32_t in[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                     key[0], key[1], key[2], key[3], key[4], key[5], key[6], key[7],
                     b, sid, rows, carry};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = in[i];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }
  int8_t* lo_row = lo + row * kCols + b;
  int8_t* hi_row = hi + row * kCols + b;
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    const uint32_t v = x[w] + in[w];
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
