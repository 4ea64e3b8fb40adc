// Device code shared by the three count-sketch kernels (sm_90a, fp32 SIMT).
//
//   cs_apply_kernel  A_tilde_k = S_k^T A for a range of sketch blocks: a signed
//                    segment-sum of A's rows into b buckets, in a (blocks, b,
//                    32-column) shared-memory tile where each warp owns whole
//                    blocks, so no two warps ever touch one address.
//   gram_kernel      G (+)= sum_k m_k A_tilde_k^T A_tilde_k over a range of
//                    blocks, on the upper triangle of 128x128 output tiles,
//                    each tile mirrored into its transpose.
//
// Both take the survivor mask (nullable: every block live) and skip a masked
// block before reading any of its data.  Sums are IEEE fp32; no tensor
// cores, no TF32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sketch {

// ---------------------------------------------------------------- apply
constexpr int CS_TD = 32;        // output columns per CTA: one per lane
constexpr int CS_THREADS = 256;  // 8 warps
constexpr int CS_ROWS = 64;      // rows of A per pass (two passes staged)
constexpr int CS_BATCH = 8;      // rows one warp updates at once
constexpr int CS_MAX_BLOCKS = 32;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the H100's per-block maximum

// One staged pass: a (CS_ROWS x 32) panel of A, then the live blocks'
// buckets and signs, (kpc x CS_ROWS) each.
__host__ __device__ inline int cs_stage_floats(int kpc) {
  return CS_ROWS * CS_TD + 2 * kpc * CS_ROWS;
}

__host__ __device__ inline int cs_smem_bytes(int kpc, int b) {
  return 4 * (kpc * b * CS_TD + 2 * cs_stage_floats(kpc));
}

// Sketch blocks one CTA accumulates at once: as many (b x 32) tiles as fit
// beside two staged passes.  0 when not even one fits (b too large).
inline int cs_blocks_per_cta(int b) {
  int kpc = (SMEM_LIMIT - 8 * CS_ROWS * CS_TD) / (4 * (b * CS_TD + 4 * CS_ROWS));
  return kpc < CS_MAX_BLOCKS ? kpc : CS_MAX_BLOCKS;
}

// 4-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Add CS_BATCH staged rows of one block into its (b x 32) tile.  Shared
// memory has no native fp32 atomic add on sm_90 (atomicAdd compiles to a
// compare-and-swap loop), so the warp that owns the block does plain
// read-modify-writes: all eight loads first, then the eight stores, which
// keeps eight updates in flight.  That is right only when the eight rows
// hit eight different buckets; the buckets are the same in every lane, so
// 28 compares find a repeat (about one batch in ten at b = 256), and such a
// batch is added row by row.  Rows past n carry sign 0; buckets outside
// [0, b) are dropped, as the reference's segment_sum drops them.
__device__ __forceinline__ void cs_add_batch(float* __restrict__ tile,
                                             const int* __restrict__ h8,
                                             const float* __restrict__ s8,
                                             const float* __restrict__ panel8,
                                             int b, int lane) {
  const int4 ha = *reinterpret_cast<const int4*>(h8);
  const int4 hb = *reinterpret_cast<const int4*>(h8 + 4);
  const float4 sa = *reinterpret_cast<const float4*>(s8);
  const float4 sb = *reinterpret_cast<const float4*>(s8 + 4);
  const int hv[CS_BATCH] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
  const float sv[CS_BATCH] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
  int bucket[CS_BATCH];
  float v[CS_BATCH];
#pragma unroll
  for (int i = 0; i < CS_BATCH; ++i) {
    bucket[i] = (unsigned)hv[i] < (unsigned)b ? hv[i] : -1 - i;
    v[i] = sv[i] * panel8[i * CS_TD + lane];
  }
  bool repeat = false;
#pragma unroll
  for (int i = 0; i < CS_BATCH; ++i)
#pragma unroll
    for (int k = i + 1; k < CS_BATCH; ++k) repeat |= bucket[i] == bucket[k];
  if (!repeat) {
    float old[CS_BATCH];
#pragma unroll
    for (int i = 0; i < CS_BATCH; ++i)
      old[i] = bucket[i] >= 0 ? tile[bucket[i] * CS_TD + lane] : 0.f;
#pragma unroll
    for (int i = 0; i < CS_BATCH; ++i)
      if (bucket[i] >= 0) tile[bucket[i] * CS_TD + lane] = old[i] + v[i];
  } else {
#pragma unroll
    for (int i = 0; i < CS_BATCH; ++i)
      if (bucket[i] >= 0) tile[bucket[i] * CS_TD + lane] += v[i];
  }
}

// grid = (ceil(kc / kpc), ceil(d / 32)), CS_THREADS threads: the CTAs that
// share a strip of A are adjacent, so they read it from L2 together.
// Blocks [k0, k0 + kc) of h/sigma (K_total, n); out is (kc, b, d), block
// k0 + j at out[j].  Masked blocks are neither accumulated nor written.
// Passes are double-buffered: while the warps add pass p, cp.async copies
// pass p + 1 into the other buffer.
__global__ void __launch_bounds__(CS_THREADS)
cs_apply_kernel(const int* __restrict__ h, const float* __restrict__ sigma,
                const float* __restrict__ a, const float* __restrict__ mask,
                float* __restrict__ out, int n, int d, int b, int k0, int kc,
                int kpc) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                                   // kpc * b * CS_TD
  float* stage = tile + kpc * b * CS_TD;                // 2 staged passes
  __shared__ int live[CS_MAX_BLOCKS];
  __shared__ int n_live;

  const int c0 = blockIdx.y * CS_TD;
  const int j0 = blockIdx.x * kpc;
  const int nk = min(kpc, kc - j0);
  if (threadIdx.x == 0) {
    int m = 0;
    for (int j = 0; j < nk; ++j)
      if (mask == nullptr || mask[k0 + j0 + j] != 0.f) live[m++] = j0 + j;
    n_live = m;
  }
  __syncthreads();
  const int nl = n_live;
  if (nl == 0) return;
  for (int i = threadIdx.x; i < nl * b * CS_TD; i += CS_THREADS) tile[i] = 0.f;

  const int per_stage = cs_stage_floats(kpc);
  auto fetch = [&](int r0, float* buf) {
    for (int i = threadIdx.x; i < CS_ROWS * CS_TD; i += CS_THREADS) {
      const int r = r0 + i / CS_TD, c = c0 + i % CS_TD;
      const bool ok = r < n && c < d;
      cp_async4(buf + i, ok ? a + (size_t)r * d + c : a, ok);
    }
    int* hb = reinterpret_cast<int*>(buf + CS_ROWS * CS_TD);
    float* sb = buf + CS_ROWS * CS_TD + kpc * CS_ROWS;
    for (int i = threadIdx.x; i < nl * CS_ROWS; i += CS_THREADS) {
      const int j = i / CS_ROWS, r = r0 + i % CS_ROWS;
      const bool ok = r < n;
      const size_t g = ok ? (size_t)(k0 + live[j]) * n + r : 0;
      cp_async4(hb + i, h + g, ok);
      cp_async4(sb + i, sigma + g, ok);
    }
    cp_async_commit();
  };
  fetch(0, stage);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r0 = 0, p = 0; r0 < n; r0 += CS_ROWS, p ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // pass p landed; every warp is done with pass p - 1
    if (r0 + CS_ROWS < n) fetch(r0 + CS_ROWS, stage + (p ^ 1) * per_stage);
    const float* panel = stage + p * per_stage;
    const int* hs = reinterpret_cast<const int*>(panel + CS_ROWS * CS_TD);
    const float* ss = panel + CS_ROWS * CS_TD + kpc * CS_ROWS;
    const int nr = min(CS_ROWS, n - r0);
    for (int j = warp; j < nl; j += CS_THREADS / 32)
      for (int r = 0; r < nr; r += CS_BATCH)
        cs_add_batch(tile + j * b * CS_TD, hs + j * CS_ROWS + r,
                     ss + j * CS_ROWS + r, panel + r * CS_TD, b, lane);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nl * b * CS_TD; i += CS_THREADS) {
    const int c = c0 + i % CS_TD;
    const int row = i / CS_TD;  // j * b + bucket
    const int j = row / b, bucket = row % b;
    if (c < d) out[((size_t)live[j] * b + bucket) * d + c] = tile[i];
  }
}

inline cudaError_t launch_cs_apply(const int* h, const float* sigma,
                                   const float* a, const float* mask,
                                   float* out, int n, int d, int b, int k0,
                                   int kc, cudaStream_t stream) {
  const int kpc_max = cs_blocks_per_cta(b);
  if (kpc_max < 1 || b < 1) return cudaErrorInvalidValue;
  const int kpc = kc < kpc_max ? kc : kpc_max;
  const int smem = cs_smem_bytes(kpc, b);
  cudaError_t err = cudaFuncSetAttribute(
      cs_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((kc + kpc - 1) / kpc, (d + CS_TD - 1) / CS_TD);
  cs_apply_kernel<<<grid, CS_THREADS, smem, stream>>>(h, sigma, a, mask, out,
                                                     n, d, b, k0, kc, kpc);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- gram
constexpr int GT = 128;        // output tile edge
constexpr int GK = 8;          // reduction rows per shared-memory step
constexpr int G_THREADS = 256; // 16 x 16 threads, 8 x 8 outputs each

// grid = T (T + 1) / 2 upper-triangle tile pairs, T = ceil(d / 128).
// at is (kc, b, d), block k0 + j at at[j]; mask indexes the full (K_total,)
// range.  accumulate: add into g instead of overwriting it.  finalize:
// divide by max(sum of the full mask, 1) (K_total when mask is null).
__global__ void __launch_bounds__(G_THREADS, 2)
gram_kernel(const float* __restrict__ at, const float* __restrict__ mask,
            float* __restrict__ g, int k0, int kc, int k_total, int b, int d,
            int accumulate, int finalize) {
  __shared__ float as[GK][GT];
  __shared__ float bs[GK][GT];
  const int T = (d + GT - 1) / GT;
  int t = blockIdx.x, ti = 0;
  while (t >= T - ti) { t -= T - ti; ++ti; }
  const int tj = ti + t;
  const int i0 = ti * GT, j0 = tj * GT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kk = 0; kk < kc; ++kk) {
    if (mask != nullptr && mask[k0 + kk] == 0.f) continue;  // CTA-uniform
    const float* blk = at + (size_t)kk * b * d;
    for (int r0 = 0; r0 < b; r0 += GK) {
#pragma unroll
      for (int q = 0; q < GK * GT / G_THREADS; ++q) {
        const int e = threadIdx.x + q * G_THREADS;
        const int rr = e / GT, col = e % GT, r = r0 + rr;
        const bool ok = r < b;
        as[rr][col] = (ok && i0 + col < d) ? blk[(size_t)r * d + i0 + col] : 0.f;
        bs[rr][col] = (ok && j0 + col < d) ? blk[(size_t)r * d + j0 + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < GK; ++rr) {
        float x[8], y[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = as[rr][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j] = bs[rr][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float n_avail = 1.f;
  if (finalize) {
    float s = 0.f;
    if (mask == nullptr) s = (float)k_total;
    else for (int k = 0; k < k_total; ++k) s += mask[k];
    n_avail = fmaxf(s, 1.f);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + tx + 16 * j;
      if (col >= d) continue;
      float v = acc[i][j];
      if (accumulate) v += g[(size_t)row * d + col];
      if (finalize) v = v / n_avail;
      g[(size_t)row * d + col] = v;
      if (ti != tj) g[(size_t)col * d + row] = v;
    }
  }
}

inline cudaError_t launch_gram(const float* at, const float* mask, float* g,
                               int k0, int kc, int k_total, int b, int d,
                               int accumulate, int finalize,
                               cudaStream_t stream) {
  const int T = (d + GT - 1) / GT;
  gram_kernel<<<T * (T + 1) / 2, G_THREADS, 0, stream>>>(
      at, mask, g, k0, kc, k_total, b, d, accumulate, finalize);
  return cudaGetLastError();
}

}  // namespace sketch
