// coded_block_matvec on Hopper: out[w] = erased[w] ? 0 : enc[w] @ x for the
// W coded row-blocks (b x s) of the 2-D product code (paper Alg. 1).
//
// Replaces the Pallas kernel src/repro/kernels/coded_matvec.py
// (coded_block_matvec), a (W, s_tiles) grid that accumulates each worker's
// (b,) product over s tiles in its resident output block and multiplies
// the erasure mask into the sum.
//
// Bound on the H100: one pass over the live workers' blocks, 2 b s fp32
// operations against 4 b s bytes, so HBM bandwidth bounds it (a streaming
// GEMV).  The TPU walks s in order inside one program; here W can be as
// small as 25 (the X^T encode), far too few CTAs for 132 SMs, so s is split
// across CTAs as the Pallas grid splits it: CTA (w, t) stages x[t*ts,
// (t+1)*ts) in shared memory, each warp takes rows of the block, its lanes
// stride the tile with 16-byte loads (when s % 4 == 0; scalar loads
// otherwise), and the warp's shuffle sum goes to a (W, tiles, b) scratch.
// A second pass adds each row's tiles in order.  No atomics: the sums run
// in one fixed order, so a result is bit-for-bit reproducible.  An erased
// worker's block is never read; the second pass writes its zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <bool kVec>
__global__ void __launch_bounds__(THREADS)
    partial_kernel(const float* __restrict__ enc, const float* __restrict__ x,
                   const uint8_t* __restrict__ erased,
                   float* __restrict__ partial, int b, int s, int ts,
                   int tiles) {
  const int w = blockIdx.y;
  const int t = blockIdx.x;
  if (erased[w]) return;
  extern __shared__ float xs[];
  const int s0 = t * ts;
  const int len = min(ts, s - s0);
  for (int i = threadIdx.x; i < len; i += THREADS) xs[i] = x[s0 + i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* blk = enc + (size_t)w * b * s + s0;
  float* out = partial + ((size_t)w * tiles + t) * b;
  for (int r = warp; r < b; r += WARPS) {
    const float* row = blk + (size_t)r * s;
    float acc = 0.f;
    if (kVec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const float4* xs4 = reinterpret_cast<const float4*>(xs);
      const int len4 = len >> 2;
#pragma unroll 4
      for (int i = lane; i < len4; i += 32) {
        const float4 a = __ldg(row4 + i);
        const float4 v = xs4[i];
        acc = fmaf(a.x, v.x, acc);
        acc = fmaf(a.y, v.y, acc);
        acc = fmaf(a.z, v.z, acc);
        acc = fmaf(a.w, v.w, acc);
      }
    } else {
#pragma unroll 4
      for (int i = lane; i < len; i += 32) acc = fmaf(__ldg(row + i), xs[i], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[r] = acc;
  }
}

// out[w, r] = sum over t of partial[w, t, r], t in order; 0 where erased.
__global__ void reduce_kernel(const float* __restrict__ partial,
                              const uint8_t* __restrict__ erased,
                              float* __restrict__ out, int w_count, int b,
                              int tiles) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)w_count * b) return;
  const int w = (int)(i / b);
  const int r = (int)(i % b);
  float acc = 0.f;
  if (!erased[w]) {
    const float* p = partial + (size_t)w * tiles * b + r;
    for (int t = 0; t < tiles; ++t) acc += p[(size_t)t * b];
  }
  out[i] = acc;
}

}  // namespace

// enc (W, b, s), x (s,), erased (W,) bool as bytes, partial (W, tiles, b)
// scratch with tiles = ceil(s / ts), out (W, b); ts a multiple of 4.
extern "C" int coded_block_matvec_launch(const float* enc, const float* x,
                                         const uint8_t* erased, float* partial,
                                         float* out, int w_count, int b, int s,
                                         int ts, void* stream) {
  if (w_count <= 0 || b <= 0) return 0;
  if (ts <= 0 || ts % 4 != 0 || w_count > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = s > 0 ? (s + ts - 1) / ts : 0;
  if (tiles > 0) {
    const dim3 grid(tiles, w_count);
    const size_t smem = (size_t)ts * sizeof(float);
    const bool vec = s % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(enc) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (vec) {
      partial_kernel<true><<<grid, THREADS, smem, st>>>(enc, x, erased,
                                                        partial, b, s, ts,
                                                        tiles);
    } else {
      partial_kernel<false><<<grid, THREADS, smem, st>>>(enc, x, erased,
                                                         partial, b, s, ts,
                                                         tiles);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t total = (int64_t)w_count * b;
  const int rt = 256;
  reduce_kernel<<<(unsigned)((total + rt - 1) / rt), rt, 0, st>>>(
      partial, erased, out, w_count, b, tiles);
  return (int)cudaGetLastError();
}
