// fwht and fwht_two_pass on Hopper: the orthonormal Walsh-Hadamard
// transform along axis 1 of x (K, n, d), n a power of two.
//
// Replaces the Pallas kernels src/repro/kernels/srht.py: fwht
// (_panel_kernel) and fwht_two_pass (_local_kernel, _across_kernel), which
// write H_n = H_n1 (x) H_n2 as two matrix-unit products with Hadamard
// factors built in VMEM and pick one pass or two by their VMEM budget.
//
// Bound on the H100: n log2(n) d additions against reading and writing
// the (n, d) panel, so it is bound by the bytes (a 2^19 x 3,000 block:
// 6.3 GB each way, ~3.8 ms at 3.35 TB/s, against 3e10 additions).
//
// fwht_two_pass: n = n1 n2 (n1 = 2^floor(log2(n) / 2), as the reference
// splits it), a local pass over each contiguous n2-row chunk (the stages
// h < n2) into out, then an across pass, in place, over the n1 chunks with
// stride n2 d (the stages h >= n2), viewed as a transform of length n1
// along (K, n1, n2 d).  The intermediate makes one round trip through
// device memory; the across pass scales by 1 / sqrt(n).  Each pass of at
// most REG_MAX_ROWS rows is fwht_reg_kernel, a butterfly in registers:
// lane c of a warp owns column c of a 32-column strip, so every row access
// is one 128-byte line; a thread loads R = min(rows, 32) rows of its
// column, runs the log2(R) stages h < R in registers, and one transpose
// through shared memory gives it the rows that the stages h >= R pair, run
// in registers again.  So a pass makes at most one shared-memory round
// trip and one barrier, and its loads and stores stream whole lines; a
// wave of such CTAs (one per SM at 1,024 rows, its 128 KB in registers)
// keeps HBM busy while others compute.  The stages run in the reference's
// order (h = 1, 2, 4, ...) on its pairs, and the scale is a product with
// the float reciprocal of sqrt(n), as PyTorch divides by a scalar on the
// card.
//
// A pass of 2,048 or 4,096 rows (fwht at 4,096, and the passes of
// fwht_two_pass at n >= 2^21) does not fit a CTA's registers at 32 columns:
// fwht_wide_kernel narrows the strip to 8 columns (one 32-byte sector a
// row) and gives each 1,024-row group of it to one CTA of a thread-block
// cluster.  Each CTA runs its group's stages h < 1,024 as the register
// pass does (registers, one transpose through shared memory, registers);
// the last one or two stages, across the groups, read the cluster's
// distributed shared memory, and the result is written once.  So the one-
// pass transform reads and writes the panel once, where the two-pass form
// makes two round trips.
//
// fwht while n <= FW_MAX_ROWS: one pass, of fwht_reg_kernel up to 1,024
// rows and of fwht_wide_kernel at 2,048 and 4,096.  Every form is scaled
// by the float reciprocal of sqrt(n), as the plain version is on the card,
// and gives its bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int FW_MAX_ROWS = 4096;  // rows of one pass (srht.py: FWHT_MAX_ROWS)

constexpr int REG_MAX_ROWS = 1024;  // rows a register pass takes
constexpr int REG_ROWS = 32;        // rows a thread holds (R)

__device__ __forceinline__ void butterfly(float& u, float& v) {
  const float a = u, b = v;
  u = a + b;
  v = a - b;
}

// One pass of length ROWS = 2^LOG_ROWS along (batches, ROWS, cols): a unit
// is one batch's 32-column strip, P = ROWS / R warps; a CTA holds
// UNITS of them (at least 256 threads).  Thread (a, c) of a unit, a its
// warp and c its lane, holds rows a R + j (j < R) of column c, then, after
// the transpose, rows a2 R + a (R / P) + q (a2 < P, q < R / P) in v[q P +
// a2].  out may equal x: a unit reads all its elements before it writes
// one.  Each output is multiplied by scale.
template <int LOG_ROWS>
struct RegPass {
  static constexpr int ROWS = 1 << LOG_ROWS;
  static constexpr int R = ROWS < REG_ROWS ? ROWS : REG_ROWS;
  static constexpr int P = ROWS / R;
  static constexpr int UNIT_THREADS = 32 * P;
  static constexpr int THREADS = UNIT_THREADS > 256 ? UNIT_THREADS : 256;
  static constexpr int UNITS = THREADS / UNIT_THREADS;
  static constexpr int SMEM = P > 1 ? UNITS * ROWS * 32 * 4 : 0;
  static_assert(ROWS <= REG_MAX_ROWS && P <= R,
                "one transpose regroups at most R x R rows");
};

template <int LOG_ROWS>
__global__ void __launch_bounds__(RegPass<LOG_ROWS>::THREADS,
                                  1024 / RegPass<LOG_ROWS>::THREADS)
fwht_reg_kernel(const float* x, float* out, long long units,
                long long strips, long long cols, float scale) {
  using T = RegPass<LOG_ROWS>;
  constexpr int R = T::R, P = T::P, Q = R / P;
  extern __shared__ float sm[];
  const int slot = threadIdx.x / T::UNIT_THREADS;
  const int a = (threadIdx.x % T::UNIT_THREADS) >> 5;
  const int c = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * T::UNITS + slot;
  const long long batch = unit / strips;
  const long long col = (unit % strips) * 32 + c;
  // A slot past the last unit, or a lane past the last column, loads zeros
  // and stores nothing, but keeps to the barrier.
  const bool live = unit < units && col < cols;
  const size_t base = (size_t)batch * T::ROWS * cols + col;

  float v[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    v[j] = live ? x[base + (size_t)(a * R + j) * cols] : 0.f;
#pragma unroll
  for (int h = 1; h < R; h <<= 1)
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (!(j & h)) butterfly(v[j], v[j + h]);

  if (P > 1) {
    float* s = sm + (size_t)slot * T::ROWS * 32;
#pragma unroll
    for (int j = 0; j < R; ++j) s[(a * R + j) * 32 + c] = v[j];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int a2 = 0; a2 < P; ++a2)
        v[q * P + a2] = s[(a2 * R + a * Q + q) * 32 + c];
#pragma unroll
    for (int e = 1; e < P; e <<= 1)
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (!(k & e)) butterfly(v[k], v[k + e]);
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int row = P > 1 ? (k % P) * R + a * Q + k / P : a * R + k;
    out[base + (size_t)row * cols] = v[k] * scale;
  }
}

template <int LOG_ROWS>
cudaError_t reg_pass(const float* x, float* out, long long batches,
                     long long cols, float scale, cudaStream_t stream) {
  using T = RegPass<LOG_ROWS>;
  if (T::SMEM > (48 << 10)) {
    cudaError_t err = cudaFuncSetAttribute(
        fwht_reg_kernel<LOG_ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
  }
  const long long strips = (cols + 31) / 32;
  const long long units = batches * strips;
  const long long ctas = (units + T::UNITS - 1) / T::UNITS;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  fwht_reg_kernel<LOG_ROWS><<<(unsigned)ctas, T::THREADS, T::SMEM, stream>>>(
      x, out, units, strips, cols, scale);
  return cudaGetLastError();
}

// A pass of ROWS = 2^LOG_ROWS (2,048 or 4,096) rows along (batches, ROWS,
// cols): a unit is one batch's WIDE_COLS-column strip, and a cluster of
// G = ROWS / 1,024 CTAs of 256 threads takes it, CTA g (its rank) rows
// [g 1,024, (g + 1) 1,024).  Thread t of a CTA holds column c = t % 8 and
// first rows g 1,024 + a 32 + j (a = t / 8, j < 32: the stages h < 32),
// then rows g 1,024 + j 32 + a (the stages 32 <= h < 1,024), each set in
// registers, the CTA's 1,024 x 8 strip in its shared memory between them;
// then, read from the cluster's shared memory, rows g2 1,024 + g 32 Q +
// q 32 + a (g2 < G, q < Q = 32 / G: the stages h >= 1,024) in v[q G + g2],
// which it writes out.  A thread writes the second set back to the slots
// it read it from, so a CTA barrier after the first set and a cluster
// barrier after the second do; a second cluster barrier keeps every CTA's
// shared memory alive until the others have read it.  Row r of a CTA lies
// in slot wide_slot(r): its two low bits XORed with bits 5 and 6, so the
// four rows a warp touches at once (four consecutive a, or four
// consecutive rows) lie in four distinct groups of 8 banks.  A CTA of 256
// threads and 32 KB lets several units share an SM, so one unit's
// butterflies overlap another's loads.  out may equal x: a unit reads all
// its elements before it writes one.  Each output is multiplied by scale.
constexpr int WIDE_COLS = 8;
constexpr int WIDE_THREADS = 256;

template <int LOG_ROWS>
struct WidePass {
  static constexpr int ROWS = 1 << LOG_ROWS;
  static constexpr int G = ROWS / REG_MAX_ROWS;
  static_assert(G == 2 || G == 4, "a wide pass has 2,048 or 4,096 rows");
};

__device__ __forceinline__ int wide_slot(int r) {
  return (r ^ ((r >> 5) & 3)) * WIDE_COLS;
}

template <int LOG_ROWS>
__global__ void __launch_bounds__(WIDE_THREADS, 4)
fwht_wide_kernel(const float* x, float* out, long long strips,
                 long long cols, float scale) {
  using T = WidePass<LOG_ROWS>;
  constexpr int G = T::G, Q = 32 / G;
  __shared__ float sw[REG_MAX_ROWS * WIDE_COLS];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int c = t % WIDE_COLS, a = t / WIDE_COLS;
  const long long unit = blockIdx.x / G;
  const long long batch = unit / strips;
  const long long col = (unit % strips) * WIDE_COLS + c;
  // A lane past the last column loads zeros and stores nothing, but keeps
  // to the barriers.
  const bool live = col < cols;
  const size_t base = (size_t)batch * T::ROWS * cols + col;

  float v[32];
  const size_t r0 = (size_t)g * REG_MAX_ROWS + a * 32;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    v[j] = live ? x[base + (r0 + j) * cols] : 0.f;
#pragma unroll
  for (int h = 1; h < 32; h <<= 1)
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (!(j & h)) butterfly(v[j], v[j + h]);
#pragma unroll
  for (int j = 0; j < 32; ++j) sw[wide_slot(a * 32 + j) + c] = v[j];
  __syncthreads();

#pragma unroll
  for (int j = 0; j < 32; ++j) v[j] = sw[wide_slot(j * 32 + a) + c];
#pragma unroll
  for (int e = 1; e < 32; e <<= 1)
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (!(j & e)) butterfly(v[j], v[j + e]);
#pragma unroll
  for (int j = 0; j < 32; ++j) sw[wide_slot(j * 32 + a) + c] = v[j];
  cluster.sync();

  const int lo = g * 32 * Q + a;
#pragma unroll
  for (int g2 = 0; g2 < G; ++g2) {
    const float* rs = cluster.map_shared_rank(sw, g2);
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q * G + g2] = rs[wide_slot(lo + q * 32) + c];
  }
  cluster.sync();
#pragma unroll
  for (int e = 1; e < G; e <<= 1)
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (!(k & e)) butterfly(v[k], v[k + e]);
  if (!live) return;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int g2 = 0; g2 < G; ++g2)
      out[base + ((size_t)g2 * REG_MAX_ROWS + lo + q * 32) * cols] =
          v[q * G + g2] * scale;
}

template <int LOG_ROWS>
cudaError_t wide_pass(const float* x, float* out, long long batches,
                      long long cols, float scale, cudaStream_t stream) {
  constexpr int G = WidePass<LOG_ROWS>::G;
  const long long strips = (cols + WIDE_COLS - 1) / WIDE_COLS;
  const long long ctas = batches * strips * G;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = G;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(WIDE_THREADS);
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fwht_wide_kernel<LOG_ROWS>, x,
                                       out, strips, cols, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One pass of the butterfly over (batches, rows, cols), its outputs
// multiplied by scale: the register kernel up to REG_MAX_ROWS rows, the
// wide kernel at 2,048 and 4,096.
cudaError_t one_pass(const float* x, float* out, long long batches, int rows,
                     long long cols, float scale, cudaStream_t stream) {
  switch (rows) {
    case 1: return reg_pass<0>(x, out, batches, cols, scale, stream);
    case 2: return reg_pass<1>(x, out, batches, cols, scale, stream);
    case 4: return reg_pass<2>(x, out, batches, cols, scale, stream);
    case 8: return reg_pass<3>(x, out, batches, cols, scale, stream);
    case 16: return reg_pass<4>(x, out, batches, cols, scale, stream);
    case 32: return reg_pass<5>(x, out, batches, cols, scale, stream);
    case 64: return reg_pass<6>(x, out, batches, cols, scale, stream);
    case 128: return reg_pass<7>(x, out, batches, cols, scale, stream);
    case 256: return reg_pass<8>(x, out, batches, cols, scale, stream);
    case 512: return reg_pass<9>(x, out, batches, cols, scale, stream);
    case 1024: return reg_pass<10>(x, out, batches, cols, scale, stream);
    case 2048: return wide_pass<11>(x, out, batches, cols, scale, stream);
    case 4096: return wide_pass<12>(x, out, batches, cols, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// fwht_two_pass's form: n = n1 n2, a local pass over the k n1 chunks of n2
// rows, then an across pass, in place, of n1 rows along (k, n1, n2 d),
// scaled by 1 / sqrt(n) as a product with the reciprocal.
cudaError_t two_pass(const float* x, float* out, int k, int n, int d,
                     cudaStream_t stream) {
  int log = 0;
  while ((1 << log) < n) ++log;
  const int n1 = 1 << (log / 2), n2 = n / n1;
  cudaError_t err = one_pass(x, out, (long long)k * n1, n2, d, 1.f, stream);
  if (err != cudaSuccess) return err;
  return one_pass(out, out, k, n1, (long long)n2 * d, 1.f / sqrtf((float)n),
                  stream);
}

}  // namespace

// The transform while n <= FW_MAX_ROWS, scaled by 1 / sqrt(n) as a product
// with the reciprocal (as PyTorch divides by a scalar on the card), in
// one pass.
extern "C" int fwht_launch(const float* x, float* out, int k, int n, int d,
                           void* stream) {
  if (n < 1 || (n & (n - 1)) || n > FW_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  if (k < 1 || d < 1) return 0;
  return (int)one_pass(x, out, k, n, d, 1.f / sqrtf((float)n),
                       (cudaStream_t)stream);
}

// One pass alone over (batches, rows, cols), its outputs divided by div as
// a product with 1 / div: what fwht_two_pass_launch runs twice, and the
// one-pass transform at any rows.  Lets a caller time the passes apart.
extern "C" int fwht_two_pass_step_launch(const float* x, float* out,
                                         long long batches, int rows,
                                         long long cols, float div,
                                         void* stream) {
  if (rows < 1 || (rows & (rows - 1)) || rows > FW_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  if (batches < 1 || cols < 1) return 0;
  return (int)one_pass(x, out, batches, rows, cols, 1.f / div,
                       (cudaStream_t)stream);
}

extern "C" int fwht_two_pass_launch(const float* x, float* out, int k, int n,
                                    int d, void* stream) {
  if (n < 1 || (n & (n - 1)) || n > FW_MAX_ROWS * FW_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  if (k < 1 || d < 1) return 0;
  return (int)two_pass(x, out, k, n, d, (cudaStream_t)stream);
}
