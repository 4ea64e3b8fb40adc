// sketch_gram_srht on Hopper: the fused SRHT -> survivor-masked Gram,
// G = (1 / max(sum m, 1)) sum_k m_k A_tilde_k^T A_tilde_k with
// A_tilde_k[c, :] = (1 / sqrt(b)) sum_{r < n} sigma_kr (-1)^popcount(r &
// rows_kc) A[r, :], the b sampled rows of the orthonormal Hadamard mix of
// the signed, zero-padded A, scaled by sqrt(n_pad / b).
//
// Replaces the Pallas kernel src/repro/kernels/sketch_gram.py
// (sketch_gram_srht through _sketch_gram and _encode_srht), which
// regenerates the (tile_n x b) encode matrix from the row index in VMEM and
// runs it through the matrix unit, so the (n_pad, d) mixed panel never
// exists.
//
// Bound on the H100: the function needs, per live block, a partial
// transform through H_n = H_n1 x H_n2 (n_pad d log2(n2) additions, then
// 2 b n1 d for the sampled rows) and b d (d + 1) for the Gram: 2.3e12 at
// the main path's shapes (K = 150 with 120 live, n = 300,000, d = 3,000,
// b = 256), ~34 ms at 67 TFLOP/s fp32, against ~4 GB of input.  This
// formulation does 2 n b d per live block for the encode instead, 5.5e13
// (0.83 s at that rate).  Padded rows carry no data, so only the n real
// rows are summed.
// Design: the sketch_gram.cu chunk walk with a dense encode in place of the
// segment-sum.  For each chunk of blocks, srht_encode_kernel computes the
// live blocks' A_tilde into scratch as a SIMT GEMM of 128 x 128 output
// tiles (samples x columns), generating each 8 x 128 slice of the +-1
// encode matrix in shared memory from the row index, the sampled rows and
// the signs instead of reading it, and the symmetric Gram kernel folds the
// chunk into G.  The CTAs of one A column strip are adjacent in the grid,
// so a chunk's blocks read each strip from L2 together.  A masked block is
// neither encoded nor read.  A partial transform through H_n = H_n1 x H_n2
// would need about 30 times fewer operations; that is later work.
#include "sketch_common.cuh"

namespace {

constexpr int ET = 128;         // output tile edge
constexpr int EK = 8;           // rows of A per shared-memory step
constexpr int E_THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each

// grid = (kc * ceil(b / 128), ceil(d / 128)).  Block k0 + j of rows
// (K_total, b) and sigma (K_total, n); out is (kc, b, d), block k0 + j at
// out[j], times scale.
__global__ void __launch_bounds__(E_THREADS, 2)
srht_encode_kernel(const int* __restrict__ rows,
                   const float* __restrict__ sigma,
                   const float* __restrict__ a, const float* __restrict__ mask,
                   float* __restrict__ out, int n, int d, int b, int k0,
                   float scale) {
  __shared__ float es[EK][ET];
  __shared__ float xs[EK][ET];
  __shared__ int sel[ET];
  const int bt = (b + ET - 1) / ET;
  const int j = blockIdx.x / bt;
  const int c0 = (blockIdx.x % bt) * ET;
  const int d0 = blockIdx.y * ET;
  const int kb = k0 + j;
  if (mask != nullptr && mask[kb] == 0.f) return;  // CTA-uniform
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int i = threadIdx.x; i < ET; i += E_THREADS)
    sel[i] = c0 + i < b ? rows[(size_t)kb * b + c0 + i] : 0;
  const float* sg = sigma + (size_t)kb * n;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;
  __syncthreads();

  for (int r0 = 0; r0 < n; r0 += EK) {
#pragma unroll
    for (int q = 0; q < EK * ET / E_THREADS; ++q) {
      const int e = threadIdx.x + q * E_THREADS;
      const int rr = e / ET, col = e % ET, r = r0 + rr;
      const bool ok = r < n;
      const float sv = ok ? sg[r] : 0.f;
      es[rr][col] = (__popc((unsigned)(r & sel[col])) & 1) ? -sv : sv;
      xs[rr][col] = (ok && d0 + col < d) ? a[(size_t)r * d + d0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < EK; ++rr) {
      float x[8], y[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = es[rr][ty + 16 * i];
#pragma unroll
      for (int q = 0; q < 8; ++q) y[q] = xs[rr][tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(x[i], y[q], acc[i][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= b) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = d0 + tx + 16 * q;
      if (col < d) out[((size_t)j * b + c) * d + col] = acc[i][q] * scale;
    }
  }
}

}  // namespace

extern "C" int sketch_gram_srht_launch(const int* rows, const float* sigma,
                                       const float* a, const float* mask,
                                       float* g, float* scratch, int k,
                                       int n, int d, int b, int chunk,
                                       void* stream) {
  if (chunk < 1 || k < 1 || b < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float scale = 1.f / sqrtf((float)b);
  const int bt = (b + ET - 1) / ET;
  for (int k0 = 0; k0 < k; k0 += chunk) {
    const int kc = chunk < k - k0 ? chunk : k - k0;
    dim3 grid(kc * bt, (d + ET - 1) / ET);
    srht_encode_kernel<<<grid, E_THREADS, 0, s>>>(rows, sigma, a, mask,
                                                  scratch, n, d, b, k0,
                                                  scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = sketch::launch_gram(scratch, mask, g, k0, kc, k, b, d, k0 > 0,
                              k0 + kc >= k, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
