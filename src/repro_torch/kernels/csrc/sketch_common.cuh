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
//           there.  Where the plan groups blocks (b small enough that a
//           group's partial sums fit in a CTA's registers),
//           cs_gather_grouped_kernel instead reads each row of a strip
//           into shared memory once for a group of live blocks.
//
// What bounds the apply on the H100 is where its partial sums live.  A
// shared-memory tile per block holds them only while b is small, and then
// every update is a shared load and store, with few warps per SM; past
// b ~1,700 no tile fits and the partial sums would go to HBM.  The gather
// keeps them in registers at any b.  Per bucket it is bound by the L2
// bandwidth of its re-reads of A (a 128-byte line per entry per 32-column
// strip); grouped, by shared memory's (below).
//
//   launch_gram         G (+)= sum_k m_k A_tilde_k^T A_tilde_k over a range
//                       of blocks: split-row upper-triangle tiles, then a
//                       fixed-order reduce that mirrors each tile (below).
//   launch_sketch_gram  the sort, then a gather and the Gram, chunk by
//                       chunk over blocks.
//
// All take the survivor mask (nullable: every block live) and skip a masked
// block before reading any of its data.  Sums are IEEE fp32 in a fixed
// order (no float atomics, no tensor cores, no TF32): two launches give the
// same bits.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
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

// ----------------------------------------------------------- copies
// Asynchronous copies into shared memory: cp.async (4 bytes, zeros and no
// read with ok false; 16 bytes) in commit groups, and tensor copies (the
// TMA unit) that complete on an mbarrier.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(s)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(s),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(s),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(s), "r"(parity)
      : "memory");
  return done != 0;
}
// Orders this thread's earlier shared-memory accesses before its later
// tensor copies' writes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The box of `map` at (column c, row r) into dst, completing on bar.
__device__ __forceinline__ void tma_load(float4* dst, const CUtensorMap* map,
                                         int c, int r, uint64_t* bar) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(d),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(b)
      : "memory");
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

// --------------------------------------------------- grouped gather
// What bounds the per-bucket gather above is L2: every live block reads
// the whole strip of A into the SMs, a 128-byte line an entry, though each
// row of A lies in one bucket of every block.  The grouped gather reads
// each row of a 32-column strip into shared memory once for a group of G
// live blocks.  grid = ceil(d / 32) strips x ceil(kc / G) groups, the strip
// outermost; one thread per output row (block, bucket) of the group, G b
// of them, which keeps that row's 32 partial sums in registers (the plan
// sizes G so that they fit) and walks its bucket's list in order.  A
// thread sums sigma times A's row for each entry with one fmaf a column in
// ascending row order, as the per-bucket gather at width 32 does: the two
// give the same bits.
//
// The strip flows through a ring of GG_RING rows in shared memory,
// GG_STAGE rows a stage, each stage one tensor copy (TMA, zeros past n and
// d) that completes on the stage's barrier.  Warps do not wait for each other: a
// warp takes a step whenever any of its threads' next row has landed,
// every such thread summing its entry, and moves on as later stages land.
// It releases a stage once all its threads are past it; the last warp to
// release a stage issues the copy of the stage that reuses its rows.  A
// warp waits only when none of its threads can step.  Lane l reads the
// eight 16-byte quarters of a row in the order i ^ (l & 7): the 8 lanes of
// each quarter-warp read distinct banks whatever their rows.
//
// A thread's entries come through shared memory too, four at a time in
// two halves: as it takes the last entry of a half it asks for the half
// after next (cp.async), so a step waits on shared memory only.
//
// Each entry costs one 128-byte row read from shared memory and 32 FFMA a
// thread; A crosses from L2 once per G blocks.  What bounds it is shared
// memory's bandwidth: a step reads a whole row a lane, and the lanes whose
// next row has not landed yet waste their share.  Rows are below 2^31 and
// entries below 2^32 (the host checks K s n).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, gather alone at
// logistic-oversketch's shape (K = 150, 120 live, n = 300,000, d = 3,000,
// b = 256): 75 ms per bucket; grouped (G = 4, R = 256) 69 ms with 16-byte
// cp.async copies of A (the copies held the SM's outstanding requests:
// ~9 bytes a clock), 210 ms with a bulk copy a row, 49 ms with a tensor
// copy a stage but a barrier of the whole CTA a stage (half the time spent
// waiting there for the slowest warp), 44 ms as above with a ring of 1,024
// rows and eight entries a thread, 41 ms with 1,536 rows and four (and
// softmax-emnist's shape 1,096 and 1,063 ms against 1,960): a larger ring
// lets more threads' rows land ahead.  With the entries read from L2, a
// step waits on its entry (39 ms here, but 1,233 ms on softmax's, whose
// entries share L2 with fewer strips).  A warp's step takes ~1,700 clocks
// for 32 warps' 34 shared-memory wavefronts each (1,100 clocks), with half
// of its 32 threads taking an entry.
constexpr int GG_THREADS = 1024;  // output rows a CTA, one a thread
constexpr int GG_MAX_GROUP = 32;  // blocks a group
constexpr int GG_RING = 1536;     // rows in the ring (192 KB)
// Rows a stage, one tensor copy: 256, the largest box a tensor copy
// takes, ran faster than 128 (the fused Gram at the shape above 51.3
// against 58.0 ms; softmax-emnist's 1,233 against 1,341).
constexpr int GG_STAGE = 256;
constexpr int GG_ENTRIES = 4;     // entries a thread holds in shared memory
constexpr int GG_SMEM = GG_RING * 32 * (int)sizeof(float) +
                        GG_ENTRIES * GG_THREADS * (int)sizeof(uint2);

template <bool kLayers>
__global__ void __launch_bounds__(GG_THREADS, 1)
    cs_gather_grouped_kernel(const int* __restrict__ off,
                             const uint2* __restrict__ ent,
                             const float* __restrict__ mask,
                             float* __restrict__ out, int n, int d, int b,
                             int s, int k0, int kc, int group, int groups,
                             float scale,
                             const __grid_constant__ CUtensorMap map) {
  constexpr int R = GG_STAGE, STAGES = GG_RING / R;
  static_assert(GG_RING % R == 0, "stages tile the ring");
  extern __shared__ __align__(128) float4 gg_ring[];  // GG_RING rows
  // Thread t's entries 2 i and 2 i + 1 of a pair of halves at
  // eb[i * GG_THREADS + t], one 16-byte copy.
  uint4* const eb = reinterpret_cast<uint4*>(gg_ring + GG_RING * 8);
  __shared__ int blk[GG_MAX_GROUP];
  __shared__ int blk_count;
  __shared__ uint64_t full[STAGES];  // stage u landed: phase u / STAGES
  __shared__ int released[STAGES];   // releases of the slot's stages
  const int strip = blockIdx.x / groups, gi = blockIdx.x % groups;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < STAGES) {
    mbar_init(full + threadIdx.x);
    released[threadIdx.x] = 0;
  }

  // The group's blocks: the live blocks of [k0, k0 + kc) numbered gi G to
  // gi G + G - 1 in order.
  if (threadIdx.x < 32) {
    const int first = gi * group;
    int count = 0;
    for (int base = 0; base < kc; base += 32) {
      const int j = base + lane;
      const bool on = j < kc && (mask == nullptr || mask[k0 + j] != 0.f);
      const unsigned bits = __ballot_sync(FULL_MASK, on);
      const int pos = count + __popc(bits & ((1u << lane) - 1u)) - first;
      if (on && pos >= 0 && pos < group) blk[pos] = j;
      count += __popc(bits);
    }
    if (lane == 0) blk_count = min(max(count - first, 0), group);
  }
  __syncthreads();
  const int live = blk_count;
  if (live == 0) return;  // CTA-uniform

  // Stage u into its ring rows.
  const int c0 = strip * 32;
  auto issue = [&](int u) {
    uint64_t* bar = full + u % STAGES;
    mbar_expect_tx(bar, R * 32 * (int)sizeof(float));
    fence_proxy_async();
    tma_load(gg_ring + ((u * R) % GG_RING) * 8, &map, c0, u * R, bar);
  };
  const int stages = (n + R - 1) / R;
  if (threadIdx.x == 0)
    for (int u = 0; u < min(STAGES, stages); ++u) issue(u);

  // This thread's output row: bucket q of the group's block g, whose
  // entries are ent[x .. xe) (indices into the whole list).
  unsigned x = 0, xe = 0;
  {
    const int g = threadIdx.x / b, q = threadIdx.x - g * b;
    if (g < live) {
      const int k = k0 + blk[g];
      const unsigned base = (unsigned)k * s * n;
      x = base + off[(size_t)k * (b + 1) + q];
      xe = base + off[(size_t)k * (b + 1) + q + 1];
    }
  }
  // The half of entries h, h + 1 (h even) into its slots, one commit
  // group.  Past the list's end a copy reads the scratch's next words,
  // which no step takes.
  uint4* const mine = eb + threadIdx.x;
  auto fetch = [&](unsigned h) {
    cp_async16(mine + ((h >> 1) & 1) * GG_THREADS, ent + h);
    cp_async_commit();
  };
  constexpr int NONE = 0x7fffffff;  // past every row
  int row = NONE;
  float sg = 0.f;
  if (x < xe) {
    const uint2 e = __ldg(ent + x);
    row = (int)e.x;
    sg = __uint_as_float(e.y);
    fetch(x & ~1u);
    if ((x | 1u) + 1 < xe) fetch((x | 1u) + 1);
  }
  cp_async_wait<0>();

  // Stage u is released by a warp once all its threads are past it; the
  // last of the CTA's warps to release it copies stage u + STAGES in.  The
  // warp barrier orders every lane's reads of the stage before lane 0's
  // fence and count (a release); the last warp's fence after the count (an
  // acquire) orders all warps' reads before its copy's write.
  const int warps = blockDim.x >> 5;
  int t = -1, rel = 0;  // stages < t + 1 have landed; < rel released
  auto release = [&](int upto) {
    __syncwarp();
    for (; rel < upto; ++rel) {
      if (lane == 0) {
        __threadfence_block();
        const int was = atomicAdd(released + rel % STAGES, 1);
        if (was == (rel / STAGES + 1) * warps - 1 && rel + STAGES < stages) {
          __threadfence_block();
          issue(rel + STAGES);
        }
      }
    }
  };

  float4 acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int sw = lane & 7;
  for (;;) {
    while (t + 1 < stages &&
           mbar_test(full + (t + 1) % STAGES, ((t + 1) / STAGES) & 1))
      ++t;
    // Rows below `avail` have landed: the warp steps if any thread can.
    // (Stepping only with most threads able, or only for rows the ring
    // must free, left warps waiting: 57-82 ms against 44 on the shape
    // below.)
    const bool last = t + 1 == stages;
    const int avail = last ? NONE : (t + 1) * R;
    const bool stepped = __any_sync(FULL_MASK, row < avail);
    if (stepped) {
      if (row < avail) {
        const float4* src = gg_ring + (row % GG_RING) * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v = src[i ^ sw];
          acc[i].x = fmaf(sg, v.x, acc[i].x);
          acc[i].y = fmaf(sg, v.y, acc[i].y);
          acc[i].z = fmaf(sg, v.z, acc[i].z);
          acc[i].w = fmaf(sg, v.w, acc[i].w);
        }
        // The last entry of a half: its slots take the half after next;
        // the next half's group is then the older of the two in flight.
        const bool more = (x & 1u) == 1u && x + 3 < xe;
        if (more) fetch(x + 3);
        ++x;
        if (x < xe) {
          if ((x & 1u) == 0u) {
            if (more) cp_async_wait<1>();
            else cp_async_wait<0>();
          }
          const uint2 e = reinterpret_cast<const uint2*>(
              mine + ((x >> 1) & 1) * GG_THREADS)[x & 1];
          row = (int)e.x;
          sg = __uint_as_float(e.y);
        } else {
          row = NONE;
        }
      }
    } else if (last) {
      break;  // every stage has landed and no thread has an entry left
    }
    // Release the stages all threads are past; with no step to take, all
    // are, and the warp waits for the next stage.
    const int least = __reduce_min_sync(FULL_MASK, row);
    release(min(least == NONE ? stages : least / R, t + 1));
    if (!stepped) mbar_wait(full + (t + 1) % STAGES, ((t + 1) / STAGES) & 1);
  }
  release(stages);
  cp_async_wait<0>();
  const int g = threadIdx.x / b, q = threadIdx.x - g * b;
  if (g >= live) return;

  // acc[i] holds columns 4 (i ^ sw) .. + 3 of the strip.
  float* o = out + ((size_t)blk[g] * b + q) * d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = c0 + 4 * (i ^ sw);
    float4 v = acc[i];
    if (kLayers) v = make_float4(v.x * scale, v.y * scale, v.z * scale,
                                 v.w * scale);
    if (col < d) *reinterpret_cast<float4*>(o + col) = v;
  }
}

// The (n x d) row-major A as a tensor map of (32 x rows) boxes, fp32, no
// swizzle; cuTensorMapEncodeTiled through the runtime's driver entry point.
inline cudaError_t strip_map(CUtensorMap* map, const float* a, int n, int d,
                             int rows) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(float)};
  const cuuint32_t box[2] = {32, (cuuint32_t)rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)a, dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The grouped gather takes A and out with 16-byte aligned rows (d % 4 == 0,
// both 16-byte aligned), as the tensor copies ask; the host plans the
// per-bucket gather for any other A.
inline cudaError_t launch_grouped(const int* off, const uint2* ent,
                                  const float* a, const float* mask,
                                  float* out, int n, int d, int b, int s,
                                  int k0, int kc, int group, float scale,
                                  cudaStream_t stream) {
  if (d % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  auto kernel = s == 1 ? cs_gather_grouped_kernel<false>
                       : cs_gather_grouped_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GG_SMEM);
  if (err != cudaSuccess) return err;
  const int groups = (kc + group - 1) / group;
  const long long blocks = (long long)((d + 31) / 32) * groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap map;
  err = strip_map(&map, a, n, d, GG_STAGE);
  if (err != cudaSuccess) return err;
  const int threads = (group * b + 31) / 32 * 32;
  kernel<<<(unsigned)blocks, threads, GG_SMEM, stream>>>(
      off, ent, mask, out, n, d, b, s, k0, kc, group, groups, scale, map);
  return cudaGetLastError();
}

// How the host planned the apply (kernels/count_sketch.py, apply_plan):
// `chunks` sort chunks per block, `width` columns per strip of the
// per-bucket gather; with `group` > 1 the grouped gather instead, `group`
// blocks a CTA.
struct ApplyPlan {
  int chunks;
  int width;
  int group;
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

// The gather of blocks [k0, k0 + kc) into out (kc, b, d): grouped where
// the plan groups blocks, else per bucket.
inline cudaError_t launch_gather(SortScratch sc, const float* a,
                                 const float* mask, float* out, int n, int d,
                                 int b, int s, int k0, int kc, ApplyPlan plan,
                                 float scale, cudaStream_t stream) {
  if (plan.group > 1) {
    if (plan.group > GG_MAX_GROUP || (long long)plan.group * b > GG_THREADS ||
        (long long)(k0 + kc) * s * n >= (1LL << 32))
      return cudaErrorInvalidValue;
    return launch_grouped(sc.off, sc.ent, a, mask, out, n, d, b, s, k0, kc,
                          plan.group, scale, stream);
  }
  switch (plan.width) {
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
  return launch_gather(sc, a, nullptr, out, n, d, b, s, 0, k, plan, scale,
                       stream);
}

// ----------------------------------------------------------------- gram
// G (+)= sum_k m_k A_k^T A_k over blocks [k0, k0 + kc) of at (kc, b, d),
// block k0 + j at at[j].  What bounds it on the H100 is the fp32 FFMA
// pipe: 2 b d^2 operations per live block against b d reads (IEEE fp32,
// no tensor cores).  Three launches:
//
//   gram_live_kernel    compacts the live blocks of the range into a list
//                       (live[0] = their count, live[1..] = their indices).
//   gram_kernel         one CTA per (upper-triangle 128 x 128 tile, slice):
//                       the live rows (live blocks x b) are cut into
//                       `slices` equal runs, and each CTA sums its run into
//                       a partial tile in scratch.  The wrapper sizes the
//                       slices (oversketch_matmul.py::gram_slices) so that
//                       tiles x slices fill whole waves of the CTAs the
//                       card holds; counted over live rows, a chunk with
//                       masked blocks still gives every CTA an equal share.
//   gram_reduce_kernel  sums each tile's partials in slice order, adds the
//                       old G (accumulate), divides by the survivor count
//                       (finalize), and writes the tile and its mirror.
//
// Inside gram_kernel: a 3-stage cp.async ring of 32-row stages (96 KB of
// dynamic shared memory, two CTAs an SM), one __syncthreads a stage, and
// an 8 x 8 register micro-tile per thread read as two float4 of each strip
// (4 LDS.128 per 64 FFMA).  Each thread walks its copy rows' block and row
// forward instead of dividing by b per row.  Every copy is 4 bytes with
// zero fill, so any d and any row stride take the one path.  On an NVIDIA
// H100 80GB HBM3 at 700 W (scripts/time_sketch_kernels.py, the nystrom-
// shaped Gram at 4 slices) 32-row stages ran in 8.0 ms against 8.7 for 4
// stages of 16 rows, and 10.9 with a division and a list read per copied
// row (7.5 ms at the 6 slices gram_slices now picks).  The
// partials are reduced in a fixed order (no float atomics): two launches
// give the same bits, and G = G^T exactly (both halves of a diagonal tile
// sum the same products in the same order).  Partials in scratch, not a
// cluster reducing through distributed shared memory: at d = 3,000 they
// are 80-120 MB written once and read once, and the reduce took 0.06 ms
// of the nystrom-shaped Gram's 7.97 at 4 slices on the H100 above; nothing
// limits how many slices share a tile.
constexpr int GT = 128;        // output tile edge
constexpr int GK = 32;         // reduction rows per stage
constexpr int G_STAGES = 3;    // stages in flight
constexpr int G_THREADS = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int G_SMEM = G_STAGES * 2 * GK * GT * (int)sizeof(float);
constexpr int G_BAND = 32;     // rows of a tile per reduce CTA

// Upper-triangle tile t of T x T tiles -> (ti, tj), ti <= tj, row-major.
__device__ __forceinline__ void gram_tile(int t, int T, int& ti, int& tj) {
  ti = 0;
  while (t >= T - ti) { t -= T - ti; ++ti; }
  tj = ti + t;
}

// One warp: live[0] = live blocks of [k0, k0 + kc), live[1..] their
// indices j (at[j]) in order; *n_avail = max(sum of the full mask, 1)
// (K_total when mask is null; a sum of 0s and 1s, exact in any order).
__global__ void gram_live_kernel(const float* __restrict__ mask,
                                 int* __restrict__ live,
                                 float* __restrict__ n_avail, int k0, int kc,
                                 int k_total) {
  const int lane = threadIdx.x;
  int count = 0;
  for (int base = 0; base < kc; base += 32) {
    const int j = base + lane;
    const bool on = j < kc && (mask == nullptr || mask[k0 + j] != 0.f);
    const unsigned bits = __ballot_sync(FULL_MASK, on);
    if (on) live[1 + count + __popc(bits & ((1u << lane) - 1u))] = j;
    count += __popc(bits);
  }
  float s = 0.f;
  if (mask == nullptr) s = lane == 0 ? (float)k_total : 0.f;
  else for (int k = lane; k < k_total; k += 32) s += mask[k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
  if (lane == 0) {
    live[0] = count;
    *n_avail = fmaxf(s, 1.f);
  }
}

// grid = tiles x slices, the tile fastest (the CTAs resident at once share
// their slice's rows in L2).  partial is (slices, tiles, 128, 128).
__global__ void __launch_bounds__(G_THREADS, 2)
gram_kernel(const float* __restrict__ at, const int* __restrict__ live,
            float* __restrict__ partial, int b, int d, int slices) {
  extern __shared__ float4 g_smem4[];
  float* const sm = reinterpret_cast<float*>(g_smem4);
  const int T = (d + GT - 1) / GT, tiles = T * (T + 1) / 2;
  const int tile = blockIdx.x % tiles, slice = blockIdx.x / tiles;
  int ti, tj;
  gram_tile(tile, T, ti, tj);
  const int i0 = ti * GT, j0 = tj * GT;
  const int rows = live[0] * b;  // < 2^31: the host checks kc b
  const int r0 = (int)((long long)rows * slice / slices);
  const int r1 = (int)((long long)rows * (slice + 1) / slices);
  const int stages = (r1 - r0 + GK - 1) / GK;
  const int* const blocks = live + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // Thread t copies column t % 128 of both strips for rows GR (t / 128)
  // + q, q < GR, of each stage: it walks its rows' live block `pos` and
  // row `rin` in that block forward, GK rows a stage, with no division.
  constexpr int GR = GK * GT / G_THREADS;
  const int lc = threadIdx.x % GT, lr = GR * (threadIdx.x / GT);
  const bool oka = i0 + lc < d, okb = j0 + lc < d;
  int pos = (r0 + lr) / b, rin = (r0 + lr) % b;

  // Stage s (the loads are issued in order s = 0, 1, ...).
  auto load = [&](int s) {
    float* as = sm + (s % G_STAGES) * 2 * GK * GT;
    float* bs = as + GK * GT;
    const int rbase = r0 + s * GK + lr;
    int p = pos, ri = rin;
    const float* row = at;
    if (rbase < r1) row = at + ((size_t)blocks[p] * b + ri) * d;
#pragma unroll
    for (int q = 0; q < GR; ++q) {
      const bool ok = rbase + q < r1;
      const int rr = lr + q;
      cp_async4(as + rr * GT + lc, ok && oka ? row + i0 + lc : at, ok && oka);
      cp_async4(bs + rr * GT + lc, ok && okb ? row + j0 + lc : at, ok && okb);
      if (++ri == b) {
        ri = 0;
        ++p;
        if (rbase + q + 1 < r1) row = at + (size_t)blocks[p] * b * d;
      } else {
        row += d;
      }
    }
    for (rin += GK; rin >= b; rin -= b) ++pos;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < stages) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < stages; ++it) {
    cp_async_wait<G_STAGES - 2>();
    __syncthreads();  // stage it landed; stage it - 1's buffer is free
    if (it + G_STAGES - 1 < stages) load(it + G_STAGES - 1);
    cp_async_commit();
    const float* as = sm + (it % G_STAGES) * 2 * GK * GT;
    const float* bs = as + GK * GT;
#pragma unroll
    for (int rr = 0; rr < GK; ++rr) {
      const float4 x0 = *reinterpret_cast<const float4*>(as + rr * GT + 4 * ty);
      const float4 x1 =
          *reinterpret_cast<const float4*>(as + rr * GT + 64 + 4 * ty);
      const float4 y0 = *reinterpret_cast<const float4*>(bs + rr * GT + 4 * tx);
      const float4 y1 =
          *reinterpret_cast<const float4*>(bs + rr * GT + 64 + 4 * tx);
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // Tile row 4 ty + i (i < 4) or 64 + 4 ty + i - 4; columns likewise.
  float* out = partial + ((size_t)slice * tiles + tile) * GT * GT;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
    float4* o = reinterpret_cast<float4*>(out + row * GT);
    o[tx] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    o[16 + tx] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// grid = (tiles, 128 / G_BAND): one band of G_BAND rows of a tile.  Sums
// the band's partials in slice order; accumulate adds g's old value,
// finalize divides by *n_avail; writes g and, off the diagonal, the
// mirror through shared memory.
__global__ void __launch_bounds__(256)
gram_reduce_kernel(const float* __restrict__ partial,
                   const float* __restrict__ n_avail, float* __restrict__ g,
                   int d, int slices, int accumulate, int finalize) {
  __shared__ float band[G_BAND][GT + 1];
  const int T = (d + GT - 1) / GT, tiles = T * (T + 1) / 2;
  const int tile = blockIdx.x;
  int ti, tj;
  gram_tile(tile, T, ti, tj);
  const int i0 = ti * GT + blockIdx.y * G_BAND, j0 = tj * GT;
  const float div = *n_avail;
  const int col = threadIdx.x % GT;
  for (int rr = threadIdx.x / GT; rr < G_BAND; rr += 256 / GT) {
    const float* p = partial + (size_t)tile * GT * GT +
                     (blockIdx.y * G_BAND + rr) * GT + col;
    float v = 0.f;
    for (int s = 0; s < slices; ++s) v += p[(size_t)s * tiles * GT * GT];
    const int row = i0 + rr, c = j0 + col;
    if (row < d && c < d) {
      if (accumulate) v += g[(size_t)row * d + c];
      if (finalize) v = v / div;
      g[(size_t)row * d + c] = v;
    }
    band[rr][col] = v;
  }
  if (ti == tj) return;  // CTA-uniform
  __syncthreads();
  const int rr = threadIdx.x % G_BAND;
  for (int cc = threadIdx.x / G_BAND; cc < GT; cc += 256 / G_BAND)
    if (i0 + rr < d && j0 + cc < d)
      g[(size_t)(j0 + cc) * d + i0 + rr] = band[rr][cc];
}

// The Gram of blocks [k0, k0 + kc) of at into g.  scratch holds the
// partial tiles (slices, tiles, 128, 128), n_avail, then the kc + 1 ints of
// the live list (kernels/oversketch_matmul.py::gram_scratch allocates it).
inline cudaError_t launch_gram(const float* at, const float* mask, float* g,
                               float* scratch, int k0, int kc, int k_total,
                               int b, int d, int slices, int accumulate,
                               int finalize, cudaStream_t stream) {
  if (slices < 1 || kc < 0 || b < 1 || d < 1 ||
      (long long)kc * b >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int T = (d + GT - 1) / GT, tiles = T * (T + 1) / 2;
  if ((long long)tiles * slices > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* n_avail = scratch + (size_t)slices * tiles * GT * GT;
  int* live = reinterpret_cast<int*>(n_avail + 1);
  gram_live_kernel<<<1, 32, 0, stream>>>(mask, live, n_avail, k0, kc,
                                         k_total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gram_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G_SMEM);
  if (err != cudaSuccess) return err;
  gram_kernel<<<tiles * slices, G_THREADS, G_SMEM, stream>>>(at, live,
                                                             scratch, b, d,
                                                             slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_reduce_kernel<<<dim3(tiles, GT / G_BAND), 256, 0, stream>>>(
      scratch, n_avail, g, d, slices, accumulate, finalize);
  return cudaGetLastError();
}


// ------------------------------------------------- fused sketch -> Gram
// G = (1 / max(sum m, 1)) sum_k m_k A_tilde_k^T A_tilde_k with A_tilde_k
// from the layered segment-sum apply: the sort of all k blocks once, then,
// chunk blocks at a time through scratch (chunk, b, d), the gather and the
// Gram; the first chunk overwrites G, the last divides by the survivor
// count.  iscratch holds the sort (sort_scratch); gscratch the Gram's
// scratch for chunk blocks (launch_gram).
inline cudaError_t launch_sketch_gram(const int* h, const float* sigma,
                                      const float* a, const float* mask,
                                      float* g, float* scratch,
                                      uint32_t* iscratch, float* gscratch,
                                      int k, int s, int n, int d, int b,
                                      int chunk, int slices, ApplyPlan plan,
                                      float scale, cudaStream_t stream) {
  if (chunk < 1 || k < 1 || b < 1 || s < 1 || n < 1 || d < 1)
    return cudaErrorInvalidValue;
  const SortScratch sc = sort_scratch(iscratch, k, s, n, b);
  cudaError_t err =
      launch_sort(h, sigma, mask, sc, k, n, b, s, plan.chunks, stream);
  if (err != cudaSuccess) return err;
  for (int k0 = 0; k0 < k; k0 += chunk) {
    const int kc = chunk < k - k0 ? chunk : k - k0;
    err = launch_gather(sc, a, mask, scratch, n, d, b, s, k0, kc, plan, scale,
                        stream);
    if (err != cudaSuccess) return err;
    err = launch_gram(scratch, mask, g, gscratch, k0, kc, k, b, d, slices,
                      k0 > 0, k0 + kc >= k, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace sketch
