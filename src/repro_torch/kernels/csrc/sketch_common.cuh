// Device code shared by the sketch kernels (sm_90a, fp32 SIMT).
//
//   cs_apply_kernel  A_tilde_k = scale * sum_t S_kt^T A for a range of
//                    sketch blocks, each with s signed segment-sum layers
//                    (count sketch: s = 1; SJLT: s > 1, scale 1/sqrt(s)),
//                    in a (blocks, b, 32-column) shared-memory tile where
//                    each warp owns whole tiles, so no two warps ever touch
//                    one address.  When one (b x 32) tile does not fit, a
//                    block's b buckets are split into ranges, one per warp.
//   gram_kernel      G (+)= sum_k m_k A_tilde_k^T A_tilde_k over a range of
//                    blocks, on the upper triangle of 128x128 output tiles,
//                    each tile mirrored into its transpose.
//   launch_sketch_gram  the two above, chunk by chunk over the blocks.
//
// All take the survivor mask (nullable: every block live) and skip a masked
// block before reading any of its data.  Sums are IEEE fp32; no tensor
// cores, no TF32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sketch {

// ---------------------------------------------------------------- apply
constexpr int CS_TD = 32;        // output columns per CTA: one per lane
constexpr int CS_THREADS = 256;  // 8 warps
constexpr int CS_WARPS = CS_THREADS / 32;
constexpr int CS_ROWS = 64;      // rows of A per pass (two passes staged)
constexpr int CS_BATCH = 8;      // rows one warp updates at once
constexpr int CS_MAX_BLOCKS = 32;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the H100's per-block maximum

// One staged pass: a (CS_ROWS x 32) panel of A, then the live blocks'
// buckets and signs, (kpc x s x CS_ROWS) each.
__host__ __device__ inline int cs_stage_floats(int kpc, int s) {
  return CS_ROWS * CS_TD + 2 * kpc * s * CS_ROWS;
}

// units tiles of (width x 32) floats beside two staged passes.
__host__ __device__ inline int cs_smem_bytes(int units, int width, int kpc,
                                             int s) {
  return 4 * (units * width * CS_TD + 2 * cs_stage_floats(kpc, s));
}

// How the apply lays a block's buckets over CTAs.  Whole mode (parts == 1):
// one CTA accumulates kpc whole blocks, one warp per block.  Split mode
// (parts > 1, when not even one (b x 32) tile fits): a CTA takes one block
// and CS_WARPS of its parts, one (width x 32) bucket range per warp; a
// block spans parts / CS_WARPS CTAs, each re-reading the A strip.
struct CsPlan {
  int kpc;    // blocks per CTA
  int parts;  // bucket ranges per block (1: whole)
  int width;  // buckets per range
};

inline CsPlan cs_plan(int b, int s) {
  const int stages = 8 * cs_stage_floats(0, 0);  // two panels, bytes
  int kpc = (SMEM_LIMIT - stages) / (4 * (b * CS_TD + 4 * s * CS_ROWS));
  if (kpc >= 1) return {kpc < CS_MAX_BLOCKS ? kpc : CS_MAX_BLOCKS, 1, b};
  const int avail = SMEM_LIMIT - 8 * cs_stage_floats(1, s);
  const int wmax = avail / (4 * CS_WARPS * CS_TD);
  const int groups = (b + CS_WARPS * wmax - 1) / (CS_WARPS * wmax);
  const int parts = groups * CS_WARPS;
  return {1, parts, (b + parts - 1) / parts};
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

// Add CS_BATCH staged rows of one layer into a (width x 32) tile whose
// first bucket is off.  Shared memory has no native fp32 atomic add on
// sm_90 (atomicAdd compiles to a compare-and-swap loop), so the warp that
// owns the tile does plain read-modify-writes: all eight loads first, then
// the eight stores, which keeps eight updates in flight.  That is right
// only when the eight rows hit eight different buckets; the buckets are the
// same in every lane, so 28 compares find a repeat (about one batch in ten
// at b = 256), and such a batch is added row by row.  Each lane owns one
// column, so successive calls (the next rows, another layer of the same
// rows) need no ordering beyond the thread's own.  Rows past n carry sign
// 0; buckets outside [off, off + width) are dropped, as the reference's
// segment_sum drops buckets outside [0, b).  kSplit: skip a batch with no
// bucket in range (warp-uniform).
template <bool kSplit>
__device__ __forceinline__ void cs_add_batch(float* __restrict__ tile,
                                             const int* __restrict__ h8,
                                             const float* __restrict__ s8,
                                             const float* __restrict__ panel8,
                                             int off, int width, int lane) {
  const int4 ha = *reinterpret_cast<const int4*>(h8);
  const int4 hb = *reinterpret_cast<const int4*>(h8 + 4);
  const float4 sa = *reinterpret_cast<const float4*>(s8);
  const float4 sb = *reinterpret_cast<const float4*>(s8 + 4);
  const int hv[CS_BATCH] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
  const float sv[CS_BATCH] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
  int bucket[CS_BATCH];
  bool any = false;
#pragma unroll
  for (int i = 0; i < CS_BATCH; ++i) {
    const int hi = hv[i] - off;
    bucket[i] = (unsigned)hi < (unsigned)width ? hi : -1 - i;
    any |= bucket[i] >= 0;
  }
  if (kSplit && !any) return;
  float v[CS_BATCH];
#pragma unroll
  for (int i = 0; i < CS_BATCH; ++i) v[i] = sv[i] * panel8[i * CS_TD + lane];
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

// grid = (ceil(kc / kpc) CTAs of kpc whole blocks, or kc * parts / CS_WARPS
// CTAs of one block's CS_WARPS bucket ranges; ceil(d / 32) column strips):
// the CTAs that share a strip of A are adjacent, so they read it from L2
// together.  Blocks [k0, k0 + kc) of h/sigma (K_total, s, n); out is
// (kc, b, d), block k0 + j at out[j], times scale.  Masked blocks are
// neither accumulated nor written.  Passes are double-buffered: while the
// warps add pass p, cp.async copies pass p + 1 into the other buffer.
// kLayers = false compiles the count sketch (s = 1, scale 1) with its
// layer loop and indexing folded away.
template <bool kSplit, bool kLayers>
__global__ void __launch_bounds__(CS_THREADS)
cs_apply_kernel(const int* __restrict__ h, const float* __restrict__ sigma,
                const float* __restrict__ a, const float* __restrict__ mask,
                float* __restrict__ out, int n, int d, int b, int s_arg,
                int k0, int kc, int kpc, int parts, int width, float scale) {
  const int s = kLayers ? s_arg : 1;
  extern __shared__ __align__(16) float smem[];
  __shared__ int live[CS_MAX_BLOCKS];
  __shared__ int n_live;

  // Units: whole mode, one per live block (offset 0, width b); split mode,
  // this CTA's CS_WARPS bucket ranges of its one block.
  const int groups = parts / CS_WARPS;
  const int j0 = kSplit ? blockIdx.x / groups : blockIdx.x * kpc;
  const int p0 = kSplit ? (blockIdx.x % groups) * CS_WARPS : 0;
  const int c0 = blockIdx.y * CS_TD;
  const int nk = kSplit ? 1 : min(kpc, kc - j0);
  if (threadIdx.x == 0) {
    int m = 0;
    for (int j = 0; j < nk; ++j)
      if (mask == nullptr || mask[k0 + j0 + j] != 0.f) live[m++] = j0 + j;
    n_live = m;
  }
  __syncthreads();
  const int nl = n_live;
  if (nl == 0) return;
  const int units = kSplit ? CS_WARPS : nl;
  float* tile = smem;                                   // units * width * 32
  float* stage = tile + units * width * CS_TD;          // 2 staged passes
  for (int i = threadIdx.x; i < units * width * CS_TD; i += CS_THREADS)
    tile[i] = 0.f;

  const int per_stage = cs_stage_floats(kpc, s);
  const int lrows = s * CS_ROWS;   // staged codes of one block per pass
  auto fetch = [&](int r0, float* buf) {
    for (int i = threadIdx.x; i < CS_ROWS * CS_TD; i += CS_THREADS) {
      const int r = r0 + i / CS_TD, c = c0 + i % CS_TD;
      const bool ok = r < n && c < d;
      cp_async4(buf + i, ok ? a + (size_t)r * d + c : a, ok);
    }
    int* hb = reinterpret_cast<int*>(buf + CS_ROWS * CS_TD);
    float* sb = buf + CS_ROWS * CS_TD + kpc * lrows;
    for (int i = threadIdx.x; i < nl * lrows; i += CS_THREADS) {
      const int j = i / lrows, t = (i / CS_ROWS) % s, r = r0 + i % CS_ROWS;
      const bool ok = r < n;
      const size_t g =
          ok ? ((size_t)(k0 + live[j]) * s + t) * n + r : 0;
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
    const float* ss = panel + CS_ROWS * CS_TD + kpc * lrows;
    const int nr = min(CS_ROWS, n - r0);
    if (kSplit) {
      const int off = (p0 + warp) * width;
      for (int t = 0; t < s; ++t)
        for (int r = 0; r < nr; r += CS_BATCH)
          cs_add_batch<true>(tile + warp * width * CS_TD,
                             hs + t * CS_ROWS + r, ss + t * CS_ROWS + r,
                             panel + r * CS_TD, off, width, lane);
    } else {
      for (int j = warp; j < nl; j += CS_WARPS)
        for (int t = 0; t < s; ++t)
          for (int r = 0; r < nr; r += CS_BATCH)
            cs_add_batch<false>(tile + j * b * CS_TD,
                                hs + j * lrows + t * CS_ROWS + r,
                                ss + j * lrows + t * CS_ROWS + r,
                                panel + r * CS_TD, 0, b, lane);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < units * width * CS_TD; i += CS_THREADS) {
    const int c = c0 + i % CS_TD;
    const int row = i / CS_TD;  // unit * width + bucket
    const int u = row / width;
    const int bucket = kSplit ? (p0 + u) * width + row % width : row % width;
    const int j = kSplit ? live[0] : live[u];
    if (c < d && bucket < b)
      out[((size_t)j * b + bucket) * d + c] = kLayers ? tile[i] * scale
                                                      : tile[i];
  }
}

// Blocks per CTA of the apply (the unit in which callers size chunks).
inline int cs_blocks_per_cta(int b, int s) { return cs_plan(b, s).kpc; }

template <bool kLayers>
inline cudaError_t launch_cs_apply_t(const int* h, const float* sigma,
                                     const float* a, const float* mask,
                                     float* out, int n, int d, int b, int s,
                                     int k0, int kc, float scale,
                                     cudaStream_t stream) {
  const CsPlan plan = cs_plan(b, s);
  const dim3 block(CS_THREADS);
  if (plan.parts == 1) {
    const int kpc = kc < plan.kpc ? kc : plan.kpc;
    const int smem = cs_smem_bytes(kpc, b, kpc, s);
    cudaError_t err = cudaFuncSetAttribute(
        cs_apply_kernel<false, kLayers>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((kc + kpc - 1) / kpc, (d + CS_TD - 1) / CS_TD);
    cs_apply_kernel<false, kLayers><<<grid, block, smem, stream>>>(
        h, sigma, a, mask, out, n, d, b, s, k0, kc, kpc, 1, b, scale);
  } else {
    const int smem = cs_smem_bytes(CS_WARPS, plan.width, 1, s);
    cudaError_t err = cudaFuncSetAttribute(
        cs_apply_kernel<true, kLayers>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(kc * (plan.parts / CS_WARPS), (d + CS_TD - 1) / CS_TD);
    cs_apply_kernel<true, kLayers><<<grid, block, smem, stream>>>(
        h, sigma, a, mask, out, n, d, b, s, k0, kc, 1, plan.parts,
        plan.width, scale);
  }
  return cudaGetLastError();
}

// s = 1 takes the count-sketch instantiation (scale must then be 1).
inline cudaError_t launch_cs_apply(const int* h, const float* sigma,
                                   const float* a, const float* mask,
                                   float* out, int n, int d, int b, int s,
                                   int k0, int kc, float scale,
                                   cudaStream_t stream) {
  if (b < 1 || s < 1 || kc < 1) return cudaErrorInvalidValue;
  return s == 1 ? launch_cs_apply_t<false>(h, sigma, a, mask, out, n, d, b,
                                           1, k0, kc, scale, stream)
                : launch_cs_apply_t<true>(h, sigma, a, mask, out, n, d, b, s,
                                          k0, kc, scale, stream);
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

// ------------------------------------------------- fused sketch -> Gram
// G = (1 / max(sum m, 1)) sum_k m_k A_tilde_k^T A_tilde_k with A_tilde_k
// from the layered segment-sum apply, chunk blocks at a time through
// scratch (chunk, b, d): the first chunk overwrites G, the last divides by
// the survivor count.
inline cudaError_t launch_sketch_gram(const int* h, const float* sigma,
                                      const float* a, const float* mask,
                                      float* g, float* scratch, int k, int s,
                                      int n, int d, int b, int chunk,
                                      float scale, cudaStream_t stream) {
  if (chunk < 1 || k < 1) return cudaErrorInvalidValue;
  for (int k0 = 0; k0 < k; k0 += chunk) {
    const int kc = chunk < k - k0 ? chunk : k - k0;
    cudaError_t err = launch_cs_apply(h, sigma, a, mask, scratch, n, d, b, s,
                                      k0, kc, scale, stream);
    if (err != cudaSuccess) return err;
    err = launch_gram(scratch, mask, g, k0, kc, k, b, d, k0 > 0,
                      k0 + kc >= k, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace sketch
