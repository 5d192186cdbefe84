// ChaCha20 (RFC 8439) block function on the CUDA cores, shared by the
// share-plane generator (chacha_planes.cu) and the fused regenerate-and-
// multiply kernels (keyed_share_dot.cu).
//
// A keyed participant's DB row r of share stream s is the ChaCha20
// keystream with counter b = 0..399 and nonce [s, r_lo, r_hi]; for rows
// R0 + off (off = 0, 1, ...) from a 32-bit row offset R0, r_lo = R0 + off
// mod 2^32 and the carry r_hi = (r_lo < off), taken against the GLOBAL
// offset from R0 (the tile-base bug the TPU kernel fixed).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mpc_iris {
namespace chacha {

constexpr int kBlocksPerRow = 400;  // 400 x 64 bytes = one 25,600-byte row

__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) {
  return __funnelshift_l(x, x, k);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

// The initial state of block `b` of the row at global offset `off` from
// `row0` (u64 nonce carry against the global offset).
__device__ __forceinline__ void init_state(uint32_t (&in)[16], const uint32_t (&key)[8],
                                           uint32_t sid, uint32_t row0, uint32_t off,
                                           uint32_t b) {
  const uint32_t rows = row0 + off;
  in[0] = 0x61707865u;
  in[1] = 0x3320646Eu;
  in[2] = 0x79622D32u;
  in[3] = 0x6B206574u;
#pragma unroll
  for (int i = 0; i < 8; ++i) in[4 + i] = key[i];
  in[12] = b;
  in[13] = sid;
  in[14] = rows;
  in[15] = rows < off ? 1u : 0u;
}

// The 16 keystream words of the block whose initial state is `in`: 20
// rounds in registers, then the input added.
__device__ __forceinline__ void block(const uint32_t (&in)[16], uint32_t (&x)[16]) {
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
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] += in[i];
}

// Two blocks at once (the same state but the counter: block b and b + 1),
// their quarter rounds interleaved: 8 independent dependency chains a
// thread instead of 4.
__device__ __forceinline__ void block_x2(const uint32_t (&in)[16], uint32_t (&xa)[16],
                                         uint32_t (&xb)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) xa[i] = xb[i] = in[i];
  xb[12] += 1u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      quarter(xa[c], xa[4 + c], xa[8 + c], xa[12 + c]);
      quarter(xb[c], xb[4 + c], xb[8 + c], xb[12 + c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      quarter(xa[c], xa[4 + (c + 1) % 4], xa[8 + (c + 2) % 4], xa[12 + (c + 3) % 4]);
      quarter(xb[c], xb[4 + (c + 1) % 4], xb[8 + (c + 2) % 4], xb[12 + (c + 3) % 4]);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    xa[i] += in[i];
    xb[i] += in[i];
  }
  xb[12] += 1u;
}

}  // namespace chacha
}  // namespace mpc_iris
