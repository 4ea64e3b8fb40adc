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
// card.  A pass of more rows (n >= 2^21) does not fit a CTA's registers
// and takes fwht_strip_kernel, scaled the same way.
//
// fwht, one pass while n <= FW_MAX_ROWS: fwht_strip_kernel, a shared-
// memory radix-2 butterfly.  It loads a strip of w columns by all rows of
// one transform (w = 32 down to 4 so the strip stays within
// FW_SMEM_BYTES), runs the log2(rows) stages in shared memory in the
// reference's order and writes the strip back.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FW_THREADS = 256;
constexpr int FW_MAX_ROWS = 4096;        // rows of one pass (srht.py: FWHT_MAX_ROWS)
constexpr int FW_SMEM_BYTES = 64 << 10;  // strip budget: 3 CTAs per SM

// log2 of the strip width for a transform of length rows: the widest
// power of two in [4, 32] whose strip fits FW_SMEM_BYTES.
int strip_log_width(int rows) {
  int wl = 5;
  while (wl > 2 && ((long long)rows << wl) * 4 > FW_SMEM_BYTES) --wl;
  return wl;
}

// grid = (ceil(cols / w), batches).  x and out are (batches, rows, cols);
// each CTA transforms columns [c0, c0 + w) of one batch along its rows
// and multiplies by f (mul) or divides by it; w = 1 << wl.  out may
// equal x.
__global__ void __launch_bounds__(FW_THREADS)
fwht_strip_kernel(const float* x, float* out, int rows, long long cols,
                  int wl, float f, bool mul) {
  extern __shared__ __align__(16) float s[];   // rows x w
  const int w = 1 << wl;
  const long long c0 = (long long)blockIdx.x * w;
  const size_t base = (size_t)blockIdx.y * rows * cols;
  const int total = rows << wl;
  for (int e = threadIdx.x; e < total; e += FW_THREADS) {
    const int r = e >> wl, c = e & (w - 1);
    s[e] = c0 + c < cols ? x[base + (size_t)r * cols + c0 + c] : 0.f;
  }
  __syncthreads();
  const int pairs = total / 2;
  for (int h = 1; h < rows; h <<= 1) {
    for (int p = threadIdx.x; p < pairs; p += FW_THREADS) {
      const int c = p & (w - 1), pair = p >> wl;
      const int i = ((pair & ~(h - 1)) << 1) | (pair & (h - 1));
      const float u = s[(i << wl) + c], v = s[((i + h) << wl) + c];
      s[(i << wl) + c] = u + v;
      s[((i + h) << wl) + c] = u - v;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < total; e += FW_THREADS) {
    const int r = e >> wl, c = e & (w - 1);
    if (c0 + c < cols)
      out[base + (size_t)r * cols + c0 + c] = mul ? s[e] * f : s[e] / f;
  }
}

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

// One pass over (batches, rows, cols), in slabs of at most 65,535 batches
// (the grid's y limit), its outputs multiplied by f (mul) or divided by it.
cudaError_t strip_pass(const float* x, float* out, long long batches,
                       int rows, long long cols, float f, bool mul,
                       cudaStream_t stream) {
  if (rows < 1 || rows > FW_MAX_ROWS || (rows & (rows - 1)) || cols < 1)
    return cudaErrorInvalidValue;
  const int wl = strip_log_width(rows), w = 1 << wl;
  const int smem = rows * w * 4;
  cudaError_t err = cudaFuncSetAttribute(
      fwht_strip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long strips = (cols + w - 1) / w;
  for (long long b0 = 0; b0 < batches; b0 += 65535) {
    const long long nb = batches - b0 < 65535 ? batches - b0 : 65535;
    const size_t off = (size_t)b0 * rows * cols;
    fwht_strip_kernel<<<dim3((unsigned)strips, (unsigned)nb), FW_THREADS,
                        smem, stream>>>(x + off, out + off, rows, cols, wl,
                                        f, mul);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One pass of a two-pass transform, its outputs divided by div as a
// product with 1 / div (as PyTorch divides by a scalar on the card): the
// register kernel up to REG_MAX_ROWS rows, the strip kernel past that.
cudaError_t two_pass_step(const float* x, float* out, long long batches,
                          int rows, long long cols, float div,
                          cudaStream_t stream) {
  const float scale = 1.f / div;
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
    default: return strip_pass(x, out, batches, rows, cols, scale, true,
                               stream);
  }
}

}  // namespace

extern "C" int fwht_launch(const float* x, float* out, int k, int n, int d,
                           void* stream) {
  return (int)strip_pass(x, out, k, n, d, sqrtf((float)n), false,
                         (cudaStream_t)stream);
}

// One pass of fwht_two_pass alone, over (batches, rows, cols), its outputs
// divided by div: what fwht_two_pass_launch runs twice.  Lets a caller time
// the local and across passes apart.
extern "C" int fwht_two_pass_step_launch(const float* x, float* out,
                                         long long batches, int rows,
                                         long long cols, float div,
                                         void* stream) {
  if (rows < 1 || (rows & (rows - 1)) || rows > FW_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  if (batches < 1 || cols < 1) return 0;
  return (int)two_pass_step(x, out, batches, rows, cols, div,
                            (cudaStream_t)stream);
}

extern "C" int fwht_two_pass_launch(const float* x, float* out, int k, int n,
                                    int d, void* stream) {
  if (n < 1 || (n & (n - 1)) || n > FW_MAX_ROWS * FW_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  if (k < 1 || d < 1) return 0;
  int log = 0;
  while ((1 << log) < n) ++log;
  const int n1 = 1 << (log / 2), n2 = n / n1;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = two_pass_step(x, out, (long long)k * n1, n2, d, 1.f, s);
  if (err != cudaSuccess) return (int)err;
  return (int)two_pass_step(out, out, k, n1, (long long)n2 * d,
                            sqrtf((float)n), s);
}
