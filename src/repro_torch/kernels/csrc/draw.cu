// draw on Hopper: jax.random's raw bits and its integer, sign, uniform and
// coin draws, bit for bit the plain versions (repro_torch/prng.py: _bits,
// randint, rademacher, uniform, bernoulli), in one grid-stride launch per
// call.  The raw bits are prng.permutation's sort keys (jax's shuffle).
//
// A kernel of the port alone: it replaces no Pallas kernel.  The reference
// draws with XLA (jax.random); the plain version hashes as ~130 elementwise
// launches on int64 tensors per 2^24 draws.  Here each thread hashes its
// counters in uint32 registers (threefry.cuh) and writes its element once:
// no temporaries, one pass over the output.  What bounds it on the H100 is
// the hash's integer instructions on the INT32 lanes (threefry.cuh; randint
// hashes twice an element), not the 4 bytes it writes.
//
// Element i of a call is counter start + i of its key (start is 0 for a
// whole draw; a test gives another to reach counters past 2^32).  Per mode,
// as prng.py computes it:
//   BITS        the 32-bit word, stored as int32;
//   RANDINT     words hb and lb under the two keys of split(key), then
//               ((hb % span) * mult + lb % span) % span + lo in uint32
//               arithmetic, mult = (2^16 % span)^2 % span (the square
//               wraps in uint32, as jax's does); each % by Lemire's direct
//               remainder with magic = ceil(2^64 / span) (mod 2^64), exact
//               for every 32-bit numerator and divisor;
//   RADEMACHER  +1 if the unit float (the word's top 23 bits over 2^23) is
//               below 1/2, that is if bit 31 is 0, else -1, in float32;
//   UNIFORM     max(lo, fma(unit, scale, lo)) with prng._fma's rounding:
//               the product of two floats is exact in double, so one DFMA
//               rounded to float is the same value as its multiply and add;
//   BERNOULLI   unit < p, as a bool byte.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

// Modes of kernels/draw.py.
enum Mode { BITS = 0, RANDINT = 1, RADEMACHER = 2, UNIFORM = 3, BERNOULLI = 4 };

constexpr int THREADS = 256;

struct Params {
  uint32_t k0, k1;      // the key (RANDINT: the key of the high words)
  uint32_t k2, k3;      // RANDINT: the key of the low words
  uint32_t span, mult;  // RANDINT
  uint64_t magic;       // RANDINT: ceil(2^64 / span) mod 2^64
  uint32_t lo;          // RANDINT: the lower bound's two's complement
  float flo, fscale;    // UNIFORM: lo and hi - lo; BERNOULLI: flo = p
};

__device__ __forceinline__ uint32_t mod(uint32_t a, uint64_t magic,
                                        uint32_t d) {
  return (uint32_t)__umul64hi(magic * a, (uint64_t)d);
}

__device__ __forceinline__ float unit_float(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

template <int MODE, typename T>
__global__ void __launch_bounds__(THREADS)
    draw_kernel(Params p, T* __restrict__ out, int64_t size, uint64_t start) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < size;
       i += stride) {
    const uint64_t c = start + (uint64_t)i;
    const uint32_t b = threefry::bits(p.k0, p.k1, c);
    if constexpr (MODE == BITS) {
      out[i] = (int32_t)b;
    } else if constexpr (MODE == RANDINT) {
      const uint32_t lb = threefry::bits(p.k2, p.k3, c);
      const uint32_t off = mod(b, p.magic, p.span) * p.mult +
                           mod(lb, p.magic, p.span);
      out[i] = (int32_t)(mod(off, p.magic, p.span) + p.lo);
    } else if constexpr (MODE == RADEMACHER) {
      out[i] = (b >> 31) ? -1.0f : 1.0f;
    } else if constexpr (MODE == UNIFORM) {
      const float v = __double2float_rn(__fma_rn(
          (double)unit_float(b), (double)p.fscale, (double)p.flo));
      out[i] = v > p.flo || v != v ? v : p.flo;   // torch.maximum(lo, v)
    } else {
      out[i] = unit_float(b) < p.flo;
    }
  }
}

template <int MODE, typename T>
int launch(const Params& p, void* out, long long size,
           unsigned long long start, cudaStream_t stream) {
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (size + THREADS - 1) / THREADS;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 8;
  const int blocks = (int)(want < cap ? want : cap);
  draw_kernel<MODE, T><<<blocks, THREADS, 0, stream>>>(
      p, static_cast<T*>(out), (int64_t)size, (uint64_t)start);
  return (int)cudaGetLastError();
}

}  // namespace

// out[i] = draw i of the mode, i in [0, size), from counter start + i.
extern "C" int draw_launch(int mode, uint32_t k0, uint32_t k1, uint32_t k2,
                           uint32_t k3, uint32_t span, uint32_t mult,
                           unsigned long long magic, uint32_t lo, float flo,
                           float fscale, void* out, long long size,
                           unsigned long long start, void* stream) {
  if (size <= 0) return 0;
  const Params p{k0, k1, k2, k3, span, mult, (uint64_t)magic, lo, flo, fscale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case BITS: return launch<BITS, int32_t>(p, out, size, start, s);
    case RANDINT: return launch<RANDINT, int32_t>(p, out, size, start, s);
    case RADEMACHER: return launch<RADEMACHER, float>(p, out, size, start, s);
    case UNIFORM: return launch<UNIFORM, float>(p, out, size, start, s);
    case BERNOULLI: return launch<BERNOULLI, bool>(p, out, size, start, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
