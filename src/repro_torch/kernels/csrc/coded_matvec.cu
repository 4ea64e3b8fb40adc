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
// GEMV).  Design: one launch, no scratch.  A task is ROWS rows of one live
// worker across all of s; a persistent grid of whole waves (the SMs times
// the CTAs each holds) walks the tasks of the live workers only, found on
// the device from the mask, so no CTA starts for an erased block and none
// is left idle while another runs.  The same launch writes the erased
// workers' zeros.  Every row is summed in one fixed order, so two calls
// give the same bits.  A task takes one of two kernels:
//
// coded_staged_kernel, where x is larger than X_L1_BYTES (the X^T encode,
// s = 300,000) and 16-byte loads apply: x streams through shared memory in
// tiles of STEP4 vectors, double-buffered with cp.async, one barrier a
// tile.  Warp r owns row r of the task across all of s and sums it in
// registers, VEC independent 16-byte loads of the row in flight per lane;
// one shuffle tree ends the row.  Each tile of x is read from L2 once per
// task and shared by its ROWS rows.
//
// coded_matvec_kernel otherwise (the X encode, s = 3,000, whose x sits in
// L1; and scalar loads, where s % 4 != 0 or a pointer is not 16-byte
// aligned): the CTA's warps split s into WARPS contiguous ranges; each
// lane loads a vector of x through L1 once and multiplies it into the
// ROWS rows, with ROWS x UNROLL independent loads of the block in flight,
// and keeps the ROWS partial sums in registers across its whole range.  A
// row's sum ends with one shuffle tree per warp and the WARPS partials
// added in warp order through shared memory.
//
// Measured on an H100 (PERF.md): the staged kernel is the faster at X^T
// and the warp ranges at X.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;    // rows of one task
constexpr int UNROLL = 2;  // vectors of each row a lane loads at once
constexpr int SCALAR_UNROLL = 4;
constexpr int VEC = 16;            // staged: vectors a lane loads at once
constexpr int STEP4 = 32 * VEC;    // staged: vectors of s in one x tile
constexpr int X_L1_BYTES = 48 << 10;
static_assert(ROWS == WARPS, "the staged kernel gives each warp one row");

// The live workers (erased[w] == 0) in order, walked by a cursor that only
// moves forward: a CTA asks for them by increasing rank.  Every warp keeps
// its own copy, the same in all lanes.
struct LiveCursor {
  int base;       // first worker of the current window of 32
  int before;     // live workers before base
  unsigned mask;  // bit i: worker base + i is live
};

__device__ __forceinline__ unsigned live_window(const uint8_t* erased,
                                                int base, int w_count) {
  const int w = base + (threadIdx.x & 31);
  return __ballot_sync(0xffffffffu, w < w_count && !erased[w]);
}

// The worker of live rank k (k at least the previous call's).
__device__ __forceinline__ int nth_live(const uint8_t* erased, int w_count,
                                        int k, LiveCursor& cur) {
  while (cur.before + __popc(cur.mask) <= k) {
    cur.before += __popc(cur.mask);
    cur.base += 32;
    cur.mask = live_window(erased, cur.base, w_count);
  }
  unsigned m = cur.mask;
  for (int i = k - cur.before; i > 0; --i) m &= m - 1;
  return cur.base + __ffs(m) - 1;
}

// Writes the erased workers' zeros (the grid strides over out) and returns
// the number of tasks, live workers times row groups, in every thread.
__device__ __forceinline__ long long live_tasks(const uint8_t* erased,
                                                float* out, int w_count,
                                                int b) {
  const long long total = (long long)w_count * b;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < total; i += (long long)gridDim.x * THREADS)
    if (erased[i / b]) out[i] = 0.f;
  int live = 0;
  for (int w0 = 0; w0 < w_count; w0 += THREADS) {
    const int w = w0 + threadIdx.x;
    live += __syncthreads_count(w < w_count && !erased[w]);
  }
  return (long long)live * ((b + ROWS - 1) / ROWS);
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& v) {
  acc = fmaf(a.x, v.x, acc);
  acc = fmaf(a.y, v.y, acc);
  acc = fmaf(a.z, v.z, acc);
  acc = fmaf(a.w, v.w, acc);
}

// Each lane's partial sums of rows [0, nr) of blk over the warp's range of
// s: vectors [lo, hi) of 4 floats.
__device__ __forceinline__ void row_sums_vec(const float* blk,
                                             const float* x, int s, int nr,
                                             int lo, int hi,
                                             float (&acc)[ROWS]) {
  const int lane = threadIdx.x & 31;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = lo + lane; i < hi; i += 32 * UNROLL) {
    float4 v[UNROLL];
    float4 a[ROWS][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = i + 32 * u;
      const bool in = j < hi;
      v[u] = in ? __ldg(x4 + j) : zero;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        a[r][u] = in && r < nr
                      ? __ldcs(reinterpret_cast<const float4*>(
                                   blk + (size_t)r * s) + j)
                      : zero;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) fma4(acc[r], a[r][u], v[u]);
  }
}

// The same over floats [lo, hi) of s, one float a load.
__device__ __forceinline__ void row_sums_scalar(const float* blk,
                                                const float* x, int s, int nr,
                                                int lo, int hi,
                                                float (&acc)[ROWS]) {
  const int lane = threadIdx.x & 31;
  for (int i = lo + lane; i < hi; i += 32 * SCALAR_UNROLL) {
    float v[SCALAR_UNROLL];
    float a[ROWS][SCALAR_UNROLL];
#pragma unroll
    for (int u = 0; u < SCALAR_UNROLL; ++u) {
      const int j = i + 32 * u;
      const bool in = j < hi;
      v[u] = in ? __ldg(x + j) : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        a[r][u] = in && r < nr ? __ldcs(blk + (size_t)r * s + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SCALAR_UNROLL; ++u)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(a[r][u], v[u], acc[r]);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(THREADS, 2)
    coded_matvec_kernel(const float* __restrict__ enc,
                        const float* __restrict__ x,
                        const uint8_t* __restrict__ erased,
                        float* __restrict__ out, int w_count, int b, int s) {
  __shared__ float part[2][WARPS][ROWS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int groups = (b + ROWS - 1) / ROWS;
  const long long tasks = live_tasks(erased, out, w_count, b);

  // This warp's range of s, in vectors of 4 floats or in floats.
  const int len = kVec ? s >> 2 : s;
  const int chunk = (len + WARPS - 1) / WARPS;
  const int lo = min(len, warp * chunk);
  const int hi = min(len, lo + chunk);

  LiveCursor cur{0, 0, live_window(erased, 0, w_count)};
  int parity = 0;
  for (long long t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int w = nth_live(erased, w_count, (int)(t / groups), cur);
    const int r0 = (int)(t % groups) * ROWS;
    const int nr = min(ROWS, b - r0);
    const float* blk = enc + ((size_t)w * b + r0) * s;
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    if (kVec)
      row_sums_vec(blk, x, s, nr, lo, hi, acc);
    else
      row_sums_scalar(blk, x, s, nr, lo, hi, acc);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float v = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) part[parity][warp][r] = v;
    }
    // One barrier a task: part alternates, so the next task's writes go to
    // the other half while this one's are read.
    __syncthreads();
    if ((int)threadIdx.x < nr) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) v += part[parity][i][threadIdx.x];
      out[(size_t)w * b + r0 + threadIdx.x] = v;
    }
    parity ^= 1;
  }
}


__device__ __forceinline__ void cp_async16(float4* smem, const float4* gmem,
                                           bool in) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(gmem), "r"(in ? 16 : 0));
}

// Copies tile st of x (vectors [st STEP4, (st + 1) STEP4), zeros past len)
// into buf, asynchronously.
__device__ __forceinline__ void stage_x(float4* buf, const float4* x4,
                                        int st, int len) {
  for (int e = threadIdx.x; e < STEP4; e += THREADS) {
    const int j = st * STEP4 + e;
    cp_async16(buf + e, x4 + (j < len ? j : 0), j < len);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// 16-byte loads only: s % 4 == 0 and enc, x 16-byte aligned.
__global__ void __launch_bounds__(THREADS, 3)
    coded_staged_kernel(const float* __restrict__ enc,
                        const float* __restrict__ x,
                        const uint8_t* __restrict__ erased,
                        float* __restrict__ out, int w_count, int b, int s) {
  extern __shared__ float4 xs[];  // two tiles of STEP4 vectors
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = (b + ROWS - 1) / ROWS;
  const long long tasks = live_tasks(erased, out, w_count, b);
  const int len = s >> 2;
  const int steps = (len + STEP4 - 1) / STEP4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  LiveCursor cur{0, 0, live_window(erased, 0, w_count)};
  for (long long t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int w = nth_live(erased, w_count, (int)(t / groups), cur);
    const int r = (int)(t % groups) * ROWS + warp;
    const bool row_in = r < b;
    const float4* row4 = reinterpret_cast<const float4*>(
        enc + ((size_t)w * b + (row_in ? r : 0)) * s);
    float acc = 0.f;
    stage_x(xs, x4, 0, len);
    for (int st = 0; st < steps; ++st) {
      // Tile st has landed for every thread, and every warp is done with
      // tile st - 1, whose buffer tile st + 1 now fills.
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      if (st + 1 < steps) stage_x(xs + ((st + 1) & 1) * STEP4, x4, st + 1, len);
      if (!row_in) continue;
      const float4* tile = xs + (st & 1) * STEP4;
      const int j0 = st * STEP4 + lane;
      float4 a[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        a[u] = j0 + 32 * u < len ? __ldcs(row4 + j0 + 32 * u) : zero;
#pragma unroll
      for (int u = 0; u < VEC; ++u) fma4(acc, a[u], tile[32 * u + lane]);
    }
    // Every warp is done with both buffers before the next task's tile 0.
    __syncthreads();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (row_in && lane == 0) out[(size_t)w * b + r] = acc;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const float* enc, const float* x,
                   const uint8_t* erased, float* out, int w_count, int b,
                   int s, cudaStream_t st) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  // Whole waves, but no more CTAs than there could be tasks.
  const long long most = (long long)w_count * ((b + ROWS - 1) / ROWS);
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > most) grid = most;
  kernel<<<(unsigned)grid, THREADS, smem, st>>>(enc, x, erased, out, w_count,
                                                b, s);
  return cudaGetLastError();
}

}  // namespace

// enc (W, b, s), x (s,), erased (W,) bool as bytes, out (W, b).
extern "C" int coded_block_matvec_launch(const float* enc, const float* x,
                                         const uint8_t* erased, float* out,
                                         int w_count, int b, int s,
                                         void* stream) {
  if (w_count <= 0 || b <= 0) return 0;
  if (s < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = s % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(enc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (!vec)
    return (int)launch(coded_matvec_kernel<false>, 0, enc, x, erased, out,
                       w_count, b, s, st);
  if ((long long)s * 4 <= X_L1_BYTES)
    return (int)launch(coded_matvec_kernel<true>, 0, enc, x, erased, out,
                       w_count, b, s, st);
  return (int)launch(coded_staged_kernel, 2 * STEP4 * 16, enc, x, erased,
                     out, w_count, b, s, st);
}
