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
// Design: a shared-memory radix-2 butterfly.  fwht_strip_kernel loads a
// strip of w columns by all rows of one transform (at most FW_MAX_ROWS
// rows, w = 32 down to 4 so the strip stays within FW_SMEM_BYTES), runs
// the log2(rows) butterfly stages in shared memory in the reference's
// order (h = 1, 2, 4, ...) and writes the strip back.  One pass does the
// whole transform while n <= FW_MAX_ROWS.  Past that, n = n1 n2
// (n1 = 2^floor(log2(n) / 2), as the reference splits it) and two passes
// of the same kernel do it: a local pass over each contiguous n2-row chunk
// (the stages h < n2) into out, and an across pass, in place, over the n1
// chunks with stride n2 d (the stages h >= n2), viewed as a transform of
// length n1 along (K, n1, n2 d).  The intermediate makes one round trip
// through device memory.  Both passes run the reference butterfly's
// additions in its order; the final pass divides by sqrt(n).
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
// and divides by div; w = 1 << wl.  out may equal x.
__global__ void __launch_bounds__(FW_THREADS)
fwht_strip_kernel(const float* x, float* out, int rows, long long cols,
                  int wl, float div) {
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
    if (c0 + c < cols) out[base + (size_t)r * cols + c0 + c] = s[e] / div;
  }
}

// One pass over (batches, rows, cols), in slabs of at most 65,535 batches
// (the grid's y limit).
cudaError_t strip_pass(const float* x, float* out, long long batches,
                       int rows, long long cols, float div,
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
                                        div);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int fwht_launch(const float* x, float* out, int k, int n, int d,
                           void* stream) {
  return (int)strip_pass(x, out, k, n, d, sqrtf((float)n),
                         (cudaStream_t)stream);
}

extern "C" int fwht_two_pass_launch(const float* x, float* out, int k, int n,
                                    int d, void* stream) {
  if (n < 1 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  int log = 0;
  while ((1 << log) < n) ++log;
  const int n1 = 1 << (log / 2), n2 = n / n1;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = strip_pass(x, out, (long long)k * n1, n2, d, 1.f, s);
  if (err != cudaSuccess) return (int)err;
  return (int)strip_pass(out, out, k, n1, (long long)n2 * d,
                         sqrtf((float)n), s);
}
