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
// A partial Hadamard transform.  Write a row r = p P + q (panel p of
// P = 256 rows, q its low bits) and a sampled row c = c_hi P + c_lo; then
// (-1)^popcount(r & c) = (-1)^popcount(p & c_hi) (-1)^popcount(q & c_lo),
// so A_tilde[c] = (1 / sqrt(b)) sum_p (-1)^popcount(p & c_hi) Y_p[c_lo]
// with Y_p = H_P (sigma (.) A[panel p]), an unnormalized length-P FWHT
// along the panel's rows.  Per element of A and live block that is log2 P
// additions for the butterfly, b / P for the samples and one sign multiply
// (~10 at b = 256), where a dense encode takes 2 b = 512.  Only panels that
// hold real rows are read or transformed (ceil(n / P) of them; the last
// one zero-filled); a sampled row c >= n is a valid row like any other.
//
// Bound on the H100: at the families_srht shapes (120 live blocks,
// n = 300,000, d = 3,000, b = 256) the transform's 9.7e11 additions run at
// the fp32 lane rate (33.5e12 a second: 29 ms), and the Gram's 2.8e11 FMA
// operations at 67 TFLOP/s (4.1 ms).  What bounds this kernel is the SM's
// shared-memory and L1 path, 128 bytes a clock: each element passes it
// five times (read from L2, a store and a load for the transpose between
// the butterfly's register and cross-warp stages, a store of Y_p, and a
// load for the samples at b / P = 1), ~73 ms at full width, and about as
// many issue slots go to the adds, the copies and their addresses.
//
// Design: one CTA (8 warps) per (live block, 32-column strip, group of 256
// samples), the CTAs of one strip adjacent in the grid so that a chunk's
// blocks read each strip's panels from L2 together.  Per panel: each warp
// loads 32 rows of the strip (lane = column) into registers, multiplies by
// the block's signs, runs the 5 butterfly stages on the row's low bits in
// registers, stores to shared memory, runs the 3 stages on the high bits
// after one transpose, stores Y_p, and each thread adds +-Y_p[c_lo] into
// its 32 samples' accumulators, which stay in registers over all panels.
// On an NVIDIA H100 80GB HBM3 at 700 W (scripts/time_sketch_kernels.py)
// the kernel ran in 161-162 ms at the families_srht shapes with 8 warps a
// CTA (122 registers) and 169-170 with 16 warps of 16 rows (64 registers,
// twice the resident warps): more warps do not help a kernel bound by the
// L1 path.  The chunk walk and the Gram are those of the other fused
// kernels: the chunk's A_tilde goes to scratch, scaled by 1 / sqrt(b), and
// launch_gram (sketch_common.cuh) folds it.  A masked block is neither
// transformed nor read.
#include "sketch_common.cuh"

namespace {

constexpr int SP = 256;          // panel rows P
constexpr int SP_LOG = 8;
constexpr int SW = 32;           // columns per strip (one per lane)
constexpr int S_THREADS = 256;   // 8 warps x 32 rows of a panel
constexpr int SG = S_THREADS;    // samples per CTA: 32 per warp

// grid = strips x groups x kc, the block fastest.  Block k0 + j of rows
// (K_total, b) and sigma (K_total, n); out is (kc, b, d), block k0 + j at
// out[j], times scale.
__global__ void __launch_bounds__(S_THREADS, 2)
srht_panel_kernel(const int* __restrict__ rows,
                  const float* __restrict__ sigma,
                  const float* __restrict__ a, const float* __restrict__ mask,
                  float* __restrict__ out, int n, int d, int b, int k0,
                  int kc, float scale) {
  // The panel's Y_p (one column per lane), its signs sigma and each
  // sample's (-1)^popcount(p & c_hi) (both by the parity of p), and each
  // sample's c_lo.
  __shared__ __align__(16) float ys[SP][SW];
  __shared__ __align__(16) float sig[2][SP];
  __shared__ __align__(16) float sgn[2][SG];
  __shared__ __align__(16) int lo[SG];
  const int groups = (b + SG - 1) / SG;
  const int j = blockIdx.x % kc;
  const int grp = (blockIdx.x / kc) % groups;
  const int strip = blockIdx.x / (kc * groups);
  const int kb = k0 + j;
  if (mask != nullptr && mask[kb] == 0.f) return;  // CTA-uniform
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int col = strip * SW + lane;
  const bool col_ok = col < d;
  const float* ac = a + (col_ok ? col : 0);
  const float* sg = sigma + (size_t)kb * n;

  // Thread t computes sample grp * SG + t's sign each panel.
  const int c_mine = grp * SG + threadIdx.x;
  int hi_mine = 0, lo_mine = 0;
  if (c_mine < b) {
    const int c = rows[(size_t)kb * b + c_mine];
    hi_mine = c >> SP_LOG;
    lo_mine = c & (SP - 1);
  }
  lo[threadIdx.x] = lo_mine;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const int panels = (n + SP - 1) / SP;
  for (int p = 0; p < panels; ++p) {
    const int buf = p & 1;
    const int r_sig = p * SP + threadIdx.x;
    sig[buf][threadIdx.x] = r_sig < n ? sg[r_sig] : 0.f;
    sgn[buf][threadIdx.x] = (__popc(p & hi_mine) & 1) ? -1.f : 1.f;
    float v[32];
    const int r0 = p * SP + w * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      v[i] = (col_ok && r0 + i < n) ? __ldg(ac + (size_t)(r0 + i) * d) : 0.f;
    // Panel p - 1's samples are added (ys and this parity's buffers free).
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const float4 s4 =
          *reinterpret_cast<const float4*>(&sig[buf][w * 32 + i]);
      v[i] *= s4.x;
      v[i + 1] *= s4.y;
      v[i + 2] *= s4.z;
      v[i + 3] *= s4.w;
    }
    // Stages on bits 0-4 of q (the warp's 32 rows), in registers.
#pragma unroll
    for (int h = 1; h < 32; h <<= 1)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!(i & h)) {
          const float x = v[i], y = v[i + h];
          v[i] = x + y;
          v[i + h] = x - y;
        }
#pragma unroll
    for (int i = 0; i < 32; ++i) ys[w * 32 + i][lane] = v[i];
    __syncthreads();
    // Stages on bits 5-7 (the warps): thread (w, lane) takes rows
    // 32 g + 4 w + i, g < 8, i < 4, of its column, and stores them back.
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[4 * g + i] = ys[32 * g + 4 * w + i][lane];
#pragma unroll
    for (int h = 1; h < 8; h <<= 1)
#pragma unroll
      for (int g = 0; g < 8; ++g)
        if (!(g & h))
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = v[4 * g + i], y = v[4 * (g + h) + i];
            v[4 * g + i] = x + y;
            v[4 * (g + h) + i] = x - y;
          }
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ys[32 * g + 4 * w + i][lane] = v[4 * g + i];
    __syncthreads();
    // Samples 32 w + i of the group: acc += +-Y_p[c_lo].
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const float4 s4 =
          *reinterpret_cast<const float4*>(&sgn[buf][w * 32 + i]);
      const int4 l4 = *reinterpret_cast<const int4*>(&lo[w * 32 + i]);
      acc[i] = fmaf(s4.x, ys[l4.x][lane], acc[i]);
      acc[i + 1] = fmaf(s4.y, ys[l4.y][lane], acc[i + 1]);
      acc[i + 2] = fmaf(s4.z, ys[l4.z][lane], acc[i + 2]);
      acc[i + 3] = fmaf(s4.w, ys[l4.w][lane], acc[i + 3]);
    }
  }

  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = grp * SG + w * 32 + i;
    if (c < b) out[((size_t)j * b + c) * d + col] = acc[i] * scale;
  }
}

}  // namespace

extern "C" int sketch_gram_srht_launch(const int* rows, const float* sigma,
                                       const float* a, const float* mask,
                                       float* g, float* scratch,
                                       float* gscratch, int k, int n, int d,
                                       int b, int chunk, int slices,
                                       void* stream) {
  if (chunk < 1 || k < 1 || b < 1 || n < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float scale = 1.f / sqrtf((float)b);
  const long long per_block =
      (long long)((d + SW - 1) / SW) * ((b + SG - 1) / SG);
  for (int k0 = 0; k0 < k; k0 += chunk) {
    const int kc = chunk < k - k0 ? chunk : k - k0;
    if (per_block * kc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    srht_panel_kernel<<<(unsigned)(per_block * kc), S_THREADS, 0, s>>>(
        rows, sigma, a, mask, scratch, n, d, b, k0, kc, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = sketch::launch_gram(scratch, mask, g, gscratch, k0, kc, k, b, d,
                              slices, k0 > 0, k0 + kc >= k, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
