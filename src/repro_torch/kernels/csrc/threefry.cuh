// threefry2x32 (20 rounds) in uint32 registers, as repro_torch/prng.py
// draws it: the partitionable layout of jax.random (jax_threefry_partitionable
// on).  Element i of a draw hashes the 64-bit counter i split into the words
// (i >> 32, i & 0xFFFFFFFF) under the key (k0, k1), and its 32-bit draw is
// the XOR of the two output words.
//
// The hash is integer work alone: per round an add, a funnel-shift rotate
// and an xor, and an add of the key schedule after every four rounds.  For
// sm_90a nvcc emits 68 instructions a hash: 20 SHF, 21 LOP3, 10 IADD3 (the
// key schedule folded into the rounds' adds) and 17 IMAD.IADD, which the
// FMA pipe issues beside the INT32 lanes.  The 51 on the INT32 lanes (64 a
// clock per SM) bound a kernel that draws, not the bytes it writes.
#pragma once

#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The 32-bit draw of counter i under the key (k0, k1).
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         uint64_t i) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = (uint32_t)(i >> 32) + ks[0];
  uint32_t x1 = (uint32_t)i + ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[r % 2][j]) ^ x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + (uint32_t)(r + 1);
  }
  return x0 ^ x1;
}

}  // namespace threefry
