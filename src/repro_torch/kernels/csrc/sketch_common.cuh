// Device code shared by the sketch kernels (sm_90a, fp32 SIMT).
//
// The segment-sum apply A_tilde_k = scale * sum_t S_kt^T A (count sketch:
// s = 1 layer, scale 1; SJLT: s layers, scale 1/sqrt(s)) runs as a sorted
// gather at every block size b:
//
//   sort    cs_hist/cs_scan/cs_scatter sort each block's (row, layer)
//           entries by bucket, a stable counting sort on the device (rows
//           stay ascending within a bucket; a bucket outside [0, b) is
//           dropped, as the reference's segment_sum drops it) into a CSR
//           list of (row, sigma) pairs.
//   gather  cs_gather_kernel gives each warp one output row (block,
//           bucket) of one column strip, which it sums in registers in the
//           list's order, sigma times A's row, and writes once: no shared-
//           memory read-modify-write and no float atomics.  The grid runs
//           strip by strip, so the CTAs resident at once share one strip
//           of A (n x width floats) in L2, and A's K s re-reads come from
//           there.
//
// What bounds the apply on the H100 is where its partial sums live.  A
// shared-memory tile per block holds them only while b is small, and then
// every update is a shared load and store, with few warps per SM; past
// b ~1,700 no tile fits and the partial sums would go to HBM.  The gather
// keeps them in registers at any b and is bound by the L2 bandwidth of its
// re-reads of A (a 128-byte line per entry per 32-column strip).
//
//   gram_kernel         G (+)= sum_k m_k A_tilde_k^T A_tilde_k over a range
//                       of blocks, on the upper triangle of 128x128 output
//                       tiles, each tile mirrored into its transpose.
//   launch_sketch_gram  the sort, then a gather and the Gram, chunk by
//                       chunk over blocks.
//
// All take the survivor mask (nullable: every block live) and skip a masked
// block before reading any of its data.  Sums are IEEE fp32 in a fixed
// order (no float atomics, no tensor cores, no TF32): two launches give the
// same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sketch {

constexpr unsigned FULL_MASK = 0xffffffffu;

// ------------------------------------------------------------ sort
// Block k's entries are its (row, layer) pairs in the order e = row * s +
// layer; the sort cuts them into `chunks` runs of ceil(n / chunks) rows.
// Scratch: ent (K, s n) sorted (row, sigma's bits) pairs, off (K, b + 1)
// bucket starts, cnt (K, chunks, b) per-chunk counts, then cursors.
constexpr int SORT_WARPS = 4;  // chunks per CTA of the scatter

// cnt[k][c][q] = entries of chunk c in bucket q (int atomics: the counts
// do not depend on their order).  grid = (chunks, K).
__global__ void cs_hist_kernel(const int* __restrict__ h,
                               const float* __restrict__ mask,
                               int* __restrict__ cnt, int n, int b, int s,
                               int chunks) {
  const int c = blockIdx.x, k = blockIdx.y;
  if (mask != nullptr && mask[k] == 0.f) return;
  const int rpc = (n + chunks - 1) / chunks;
  const int r0 = c * rpc, r1 = min(n, r0 + rpc);
  int* row = cnt + ((size_t)k * chunks + c) * b;
  for (int t = 0; t < s; ++t) {
    const int* ht = h + ((size_t)k * s + t) * n;
    for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
      const int q = ht[r];
      if ((unsigned)q < (unsigned)b) atomicAdd(row + q, 1);
    }
  }
}

// Per block (grid = K, 1,024 threads): off[k][q] = the entries in buckets
// below q (off[k][b] = all of them), and cnt[k][c][q] becomes the first
// position of chunk c's entries in bucket q.
__global__ void __launch_bounds__(1024)
    cs_scan_kernel(int* __restrict__ cnt, int* __restrict__ off,
                   const float* __restrict__ mask, int b, int chunks) {
  const int k = blockIdx.x;
  if (mask != nullptr && mask[k] == 0.f) return;
  __shared__ int warp_sums[32];
  int* ck = cnt + (size_t)k * chunks * b;
  const int per = (b + blockDim.x - 1) / blockDim.x;
  const int q0 = min(b, (int)threadIdx.x * per), q1 = min(b, q0 + per);
  int local = 0;
  for (int q = q0; q < q1; ++q)
    for (int c = 0; c < chunks; ++c) local += ck[(size_t)c * b + q];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, v, o);
      if (lane >= o) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  int run = x - local + (w > 0 ? warp_sums[w - 1] : 0);
  int* ok = off + (size_t)k * (b + 1);
  for (int q = q0; q < q1; ++q) {
    ok[q] = run;
    for (int c = 0; c < chunks; ++c) {
      const int t = ck[(size_t)c * b + q];
      ck[(size_t)c * b + q] = run;
      run += t;
    }
  }
  if (threadIdx.x == blockDim.x - 1) ok[b] = run;
}

// One warp per chunk (grid = (ceil(chunks / SORT_WARPS), K)) walks its
// entries 32 at a time in order: lanes with one bucket find their rank
// among themselves (__match_any_sync), write (row, sigma) at the bucket's
// cursor plus rank, and the lowest of them moves the cursor.  Entries keep
// their order within a bucket, so the sort is stable and the same on every
// call.
__global__ void cs_scatter_kernel(const int* __restrict__ h,
                                  const float* __restrict__ sigma,
                                  const float* __restrict__ mask, int* cnt,
                                  uint2* __restrict__ ent, int n, int b,
                                  int s, int chunks) {
  const int k = blockIdx.y;
  const int c = blockIdx.x * SORT_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= chunks || (mask != nullptr && mask[k] == 0.f)) return;
  volatile int* cur = cnt + ((size_t)k * chunks + c) * b;
  uint2* ek = ent + (size_t)k * s * n;
  const int rpc = (n + chunks - 1) / chunks;
  const int r0 = c * rpc, r1 = min(n, r0 + rpc);
  const int e_end = r1 > r0 ? (r1 - r0) * s : 0;
  for (int e0 = 0; e0 < e_end; e0 += 32) {
    const int e = e0 + lane;
    int key = -1;
    uint2 val = make_uint2(0u, 0u);
    if (e < e_end) {
      const int r = r0 + e / s, t = e % s;
      const size_t src = ((size_t)k * s + t) * n + r;
      const int q = h[src];
      if ((unsigned)q < (unsigned)b) {
        key = q;
        val = make_uint2((uint32_t)r, __float_as_uint(sigma[src]));
      }
    }
    const unsigned peers = __match_any_sync(FULL_MASK, key);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    int base = 0;
    if (key >= 0) {
      base = cur[key];
      ek[base + rank] = val;
    }
    __syncwarp();
    if (key >= 0 && rank == 0) cur[key] = base + __popc(peers);
    __syncwarp();
  }
}

// ----------------------------------------------------------- gather
// grid = ceil(d / W) strips x kc blocks x ceil(b / 8) bucket groups, the
// strip outermost; 8 warps, one bucket each.  The warp's lanes form 32 / W
// groups of W columns: group g sums entries g, g + 32/W, ... of the
// bucket's list, then the groups' sums are added in a fixed tree.  Entries
// are read 32 at a time by the warp and passed round by shuffles; A's rows
// are read through L2, where the strip stays while the resident CTAs work
// on it.  out is (kc, b, d), block k0 + j at out[j], times scale.
template <int W, bool kLayers>
__global__ void __launch_bounds__(256)
    cs_gather_kernel(const int* __restrict__ off,
                     const uint2* __restrict__ ent,
                     const float* __restrict__ a,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int n, int d, int b, int s, int k0, int kc, float scale) {
  constexpr int G = 32 / W;
  const int groups = (b + 7) / 8;
  const long long per_strip = (long long)kc * groups;
  const int strip = (int)(blockIdx.x / per_strip);
  const int rem = (int)(blockIdx.x % per_strip);
  const int j = rem / groups;
  const int k = k0 + j;
  if (mask != nullptr && mask[k] == 0.f) return;
  const int q = (rem % groups) * 8 + (threadIdx.x >> 5);
  if (q >= b) return;
  const int lane = threadIdx.x & 31;
  const int g = lane / W;
  const int col = strip * W + lane % W;
  const bool col_ok = col < d;
  const int* ok = off + (size_t)k * (b + 1);
  const int e0 = ok[q], e1 = ok[q + 1];
  const uint2* ek = ent + (size_t)k * s * n;
  const float* ac = a + (col_ok ? col : 0);
  float acc = 0.f;
  for (int base = e0; base < e1; base += 32) {
    const int m = min(32, e1 - base);
    const uint2 mine = lane < m ? __ldcs(ek + base + lane) : make_uint2(0u, 0u);
#pragma unroll
    for (int i = 0; i < 32 / G; ++i) {
      const int idx = i * G + g;
      const uint32_t row = __shfl_sync(FULL_MASK, mine.x, idx);
      const float sg = __uint_as_float(__shfl_sync(FULL_MASK, mine.y, idx));
      if (idx < m && col_ok) acc = fmaf(sg, __ldg(ac + (size_t)row * d), acc);
    }
  }
#pragma unroll
  for (int o = W; o < 32; o <<= 1) acc += __shfl_down_sync(FULL_MASK, acc, o);
  if (g == 0 && col_ok)
    out[((size_t)j * b + q) * d + col] = kLayers ? acc * scale : acc;
}

template <int W>
inline cudaError_t launch_gather_w(const int* off, const uint2* ent,
                                   const float* a, const float* mask,
                                   float* out, int n, int d, int b, int s,
                                   int k0, int kc, float scale,
                                   cudaStream_t stream) {
  const long long blocks =
      (long long)((d + W - 1) / W) * kc * ((b + 7) / 8);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (s == 1)
    cs_gather_kernel<W, false><<<(unsigned)blocks, 256, 0, stream>>>(
        off, ent, a, mask, out, n, d, b, 1, k0, kc, scale);
  else
    cs_gather_kernel<W, true><<<(unsigned)blocks, 256, 0, stream>>>(
        off, ent, a, mask, out, n, d, b, s, k0, kc, scale);
  return cudaGetLastError();
}

// How the host planned the apply (kernels/count_sketch.py, apply_plan):
// `chunks` sort chunks per block and `width` columns per strip.
struct ApplyPlan {
  int chunks;
  int width;
};

// The scratch, in int32 words: ent 2 K s n, off K (b + 1), cnt K chunks b.
struct SortScratch {
  uint2* ent;
  int* off;
  int* cnt;
};
inline SortScratch sort_scratch(uint32_t* base, int k, int s, int n, int b) {
  uint2* ent = reinterpret_cast<uint2*>(base);
  int* off = reinterpret_cast<int*>(base + 2 * (size_t)k * s * n);
  return {ent, off, off + (size_t)k * (b + 1)};
}

// The sort of all k blocks (masked ones skipped).
inline cudaError_t launch_sort(const int* h, const float* sigma,
                               const float* mask, SortScratch sc, int k,
                               int n, int b, int s, int chunks,
                               cudaStream_t stream) {
  if (chunks < 1 || (long long)s * n >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      sc.cnt, 0, sizeof(int) * (size_t)k * chunks * b, stream);
  if (err != cudaSuccess) return err;
  cs_hist_kernel<<<dim3(chunks, k), 256, 0, stream>>>(h, mask, sc.cnt, n, b,
                                                      s, chunks);
  cs_scan_kernel<<<k, 1024, 0, stream>>>(sc.cnt, sc.off, mask, b, chunks);
  cs_scatter_kernel<<<dim3((chunks + SORT_WARPS - 1) / SORT_WARPS, k),
                      32 * SORT_WARPS, 0, stream>>>(h, sigma, mask, sc.cnt,
                                                    sc.ent, n, b, s, chunks);
  return cudaGetLastError();
}

// The gather of blocks [k0, k0 + kc) into out (kc, b, d).
inline cudaError_t launch_gather(SortScratch sc, const float* a,
                                 const float* mask, float* out, int n, int d,
                                 int b, int s, int k0, int kc, int width,
                                 float scale, cudaStream_t stream) {
  switch (width) {
    case 8:
      return launch_gather_w<8>(sc.off, sc.ent, a, mask, out, n, d, b, s, k0,
                                kc, scale, stream);
    case 16:
      return launch_gather_w<16>(sc.off, sc.ent, a, mask, out, n, d, b, s, k0,
                                 kc, scale, stream);
    case 32:
      return launch_gather_w<32>(sc.off, sc.ent, a, mask, out, n, d, b, s, k0,
                                 kc, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The apply of all k blocks into out (k, b, d): the sort, then the gather.
inline cudaError_t launch_cs_apply(const int* h, const float* sigma,
                                   const float* a, float* out,
                                   uint32_t* scratch, int k, int s, int n,
                                   int d, int b, ApplyPlan plan, float scale,
                                   cudaStream_t stream) {
  if (b < 1 || s < 1 || k < 1 || n < 1 || d < 1) return cudaErrorInvalidValue;
  const SortScratch sc = sort_scratch(scratch, k, s, n, b);
  cudaError_t err =
      launch_sort(h, sigma, nullptr, sc, k, n, b, s, plan.chunks, stream);
  if (err != cudaSuccess) return err;
  return launch_gather(sc, a, nullptr, out, n, d, b, s, 0, k, plan.width,
                       scale, stream);
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
// from the layered segment-sum apply: the sort of all k blocks once, then,
// chunk blocks at a time through scratch (chunk, b, d), the gather and the
// Gram; the first chunk overwrites G, the last divides by the survivor
// count.  iscratch holds the sort (sort_scratch).
inline cudaError_t launch_sketch_gram(const int* h, const float* sigma,
                                      const float* a, const float* mask,
                                      float* g, float* scratch,
                                      uint32_t* iscratch, int k, int s, int n,
                                      int d, int b, int chunk, ApplyPlan plan,
                                      float scale, cudaStream_t stream) {
  if (chunk < 1 || k < 1 || b < 1 || s < 1 || n < 1 || d < 1)
    return cudaErrorInvalidValue;
  const SortScratch sc = sort_scratch(iscratch, k, s, n, b);
  cudaError_t err =
      launch_sort(h, sigma, mask, sc, k, n, b, s, plan.chunks, stream);
  if (err != cudaSuccess) return err;
  for (int k0 = 0; k0 < k; k0 += chunk) {
    const int kc = chunk < k - k0 ? chunk : k - k0;
    err = launch_gather(sc, a, mask, scratch, n, d, b, s, k0, kc, plan.width,
                        scale, stream);
    if (err != cudaSuccess) return err;
    err = launch_gram(scratch, mask, g, k0, kc, k, b, d, k0 > 0,
                      k0 + kc >= k, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace sketch
