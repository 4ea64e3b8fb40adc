// normal on Hopper: jax.random.normal's float32 draws, bit for bit the
// plain version (repro_torch/prng.py::normal_plain), as one hash and one
// table read a draw.
//
// A kernel of the port alone: it replaces no Pallas kernel.  The reference
// draws its normals with XLA (jax.random.normal); the plain version
// hashes with ~130 int64 elementwise launches per 2^24 draws, then runs
// XLA's erfinv through float64, which is far too slow for the gaussian
// sketch family's 1.15e10 draws per Newton iteration at full width.
//
// A normal draw is a function of the top 23 bits of its 32-bit word
// alone: the uniform is the mantissa trick on bits >> 9, then one fixed
// FMA and a max.  So there are 2^23 outputs, and the table T[m] of all of
// them (32 MiB of float32) is exact by construction.  normal_table_kernel
// computes it once per device, in the float32 steps of prng.py:
//   u      the mantissa m over 2^23, then uniform's FMA on
//          [nextafter(-1, 0), 1) and the max with its lower end;
//   erfinv XLA's polynomial in w = -log1p(-u u), with log1p and log in
//          XLA's CPU form (prng.log1p_f32, prng.log_f32);
//   T[m]   sqrt(2) erfinv(u).
// Every float32 operation is an explicitly rounded intrinsic (__fadd_rn,
// __fmul_rn, __fdiv_rn: nothing is contracted into an FMA), every _fma of
// prng.py is computed as it is there (the product and the sum in float64,
// then rounded to float32), and the square root is float64's, correctly
// rounded, then rounded to float32.  The polynomial coefficients and the
// uniform's bounds come from prng.py at launch (kernels/normal.py packs
// them), so the two versions cannot drift apart.
//
// normal_kernel then draws: threefry2x32 of counter i (threefry.cuh), a
// 4-byte read of T[bits >> 9] and a streaming store.  The table stays in
// the H100's 50 MB L2 while the output streams past it (__stcs marks the
// stores evict-first), so what bounds a draw is the hash's integer
// instructions and the table's 32-byte L2 sector per read, not the 4
// bytes written.  At 32 MiB the reads cost more than from a table of 16
// MiB or less, and neither an evict_last policy nor a persisting L2
// window (its set-aside is smaller than the table) helps
// (scripts/time_normal_gather.py).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

// The packed constants, in kernels/normal.py's order.
struct Consts {
  float log_p[9];
  float log_q1, log_q2, sqrt_half, min_normal;
  float log1p_small;
  float log1p_num[7];
  float log1p_den[7];
  float erfinv_lt5[9];
  float erfinv_ge5[9];
  float lo, scale, sqrt2;
};
constexpr int N_CONSTS = sizeof(Consts) / sizeof(float);

constexpr int THREADS = 256;
constexpr int TABLE_SIZE = 1 << 23;   // one entry per 23-bit mantissa

__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ float log_f32(const Consts& c, float x) {
  const int v = __float_as_int(fmaxf(x, c.min_normal));
  float m = __int_as_float((v & 0x807FFFFF) | 0x3F000000);
  float e = __fadd_rn((float)((v >> 23) - 0x7F), 1.0f);
  const bool low = m < c.sqrt_half;
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  m = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(x2, m);
  const float* p = c.log_p;
  float y = fma64(m, p[0], p[1]);
  float y1 = fma64(m, p[3], p[4]);
  float y2 = fma64(m, p[6], p[7]);
  y = fma64(y, m, p[2]);
  y1 = fma64(y1, m, p[5]);
  y2 = fma64(y2, m, p[8]);
  y = fma64(y, x3, y1);
  y = fma64(y, x3, y2);
  y = fma64(y, x3, __fmul_rn(c.log_q1, e));
  m = fma64(-0.5f, x2, m);
  m = fma64(c.log_q2, e, __fadd_rn(m, y));
  if (fabsf(x) < c.min_normal) m = -INFINITY;
  if (x == INFINITY) m = INFINITY;
  if (x < 0.0f || isnan(x)) m = NAN;
  return m;
}

__device__ float log1p_f32(const Consts& c, float x) {
  if (!(fabsf(x) < c.log1p_small)) return log_f32(c, __fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  float num = c.log1p_num[0];
  float den = c.log1p_den[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    num = fma64(num, x, c.log1p_num[i]);
    den = fma64(den, x, c.log1p_den[i]);
  }
  const float q = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den));
  return __fadd_rn(x, fma64(-0.5f, x2, q));
}

__device__ float erfinv_f32(const Consts& c, float x) {
  const float w = -log1p_f32(c, __fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  const float t =
      lt ? __fsub_rn(w, 2.5f)
         : __fsub_rn(__double2float_rn(__dsqrt_rn((double)w)), 3.0f);
  const float* k = lt ? c.erfinv_lt5 : c.erfinv_ge5;
  float p = k[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fma64(p, t, k[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
}

// T[m] for m in [0, 2^23): the computed form of every draw.
__global__ void __launch_bounds__(THREADS)
    normal_table_kernel(const float* __restrict__ consts,
                        float* __restrict__ table) {
  __shared__ Consts c;
  for (int i = threadIdx.x; i < N_CONSTS; i += THREADS)
    reinterpret_cast<float*>(&c)[i] = consts[i];
  __syncthreads();
  const uint32_t m = blockIdx.x * THREADS + threadIdx.x;
  const float f = __fsub_rn(__uint_as_float(m | 0x3F800000u), 1.0f);
  const float u = fmaxf(c.lo, fma64(f, c.scale, c.lo));
  table[m] = __fmul_rn(c.sqrt2, erfinv_f32(c, u));
}

__global__ void __launch_bounds__(THREADS)
    normal_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ table,
                  float* __restrict__ out, int64_t size) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < size;
       i += stride) {
    const uint32_t bits = threefry::bits(k0, k1, (uint64_t)i);
    __stcs(out + i, __ldg(table + (bits >> 9)));
  }
}

// bfloat16 draws (jax.random.normal(key, shape, jnp.bfloat16)): jax draws
// one byte a bfloat16 element, the low byte of the same 32-bit word, and
// the uniform keeps its top 7 bits, so a draw is one of 128 values:
// out[i] = table[(bits >> 1) & 127], the table computed on the host by
// prng.normal_bf16_table.  The draws are bfloat16 bit patterns.
__global__ void __launch_bounds__(THREADS)
    normal_bf16_kernel(uint32_t k0, uint32_t k1,
                       const uint16_t* __restrict__ table,
                       uint16_t* __restrict__ out, int64_t size) {
  __shared__ uint16_t t[128];
  if (threadIdx.x < 128) t[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < size;
       i += stride) {
    const uint32_t bits = threefry::bits(k0, k1, (uint64_t)i);
    __stcs(out + i, t[(bits >> 1) & 127u]);
  }
}

// The window mode: a box of a draw of a whole shape (a rank's shard of a
// sharded leaf), each element hashing the 64-bit counter of its flat
// index in the whole shape, so the box holds the same bits as the same
// box of a whole draw.  A warp takes a chunk of the box at a time: up to
// WINDOW_CHUNK elements of one row of the box's last dim (a long row is
// cut into column blocks), or WINDOW_CHUNK / (row length) whole rows of a
// short one (the 30B expert leaves' shards have rows of 192).  Its lanes
// take neighbouring columns, so each store is coalesced, and the row's
// first counter comes from its multi-index: decoded once a chunk (a
// 64-bit division per box dim), then advanced row by row like an
// odometer, with no division and no barrier.  Like the whole draw, it is
// bound by the hash's integer instructions.
constexpr int MAX_RANK = 8;
constexpr int WINDOW_CHUNK = 2048;
constexpr int WARPS = THREADS / 32;

struct Box {
  int rank;
  int64_t stride[MAX_RANK];  // the whole shape's row-major strides
  int64_t start[MAX_RANK];
  int64_t size[MAX_RANK];
  int64_t rows;              // the box's rows: all dims but the last
  int64_t rows_per_chunk;    // 1 where a row is cut into column blocks
  int64_t col_blocks;        // column blocks of a row
  int64_t chunks;
};

template <typename T, int SHIFT, uint32_t MASK, bool SMEM_TABLE>
__global__ void __launch_bounds__(THREADS)
    normal_window_kernel(uint32_t k0, uint32_t k1, const T* __restrict__ table,
                         T* __restrict__ out, const Box box) {
  __shared__ T t[128];
  if constexpr (SMEM_TABLE) {
    if (threadIdx.x < 128) t[threadIdx.x] = table[threadIdx.x];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * WARPS;
  const int last = box.rank - 1;
  const int64_t inner = box.size[last];
  for (int64_t chunk = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
       chunk < box.chunks; chunk += warps) {
    const int64_t rb = chunk / box.col_blocks;
    const int64_t c0 = (chunk - rb * box.col_blocks) * WINDOW_CHUNK;
    const int64_t c1 = c0 + WINDOW_CHUNK < inner ? c0 + WINDOW_CHUNK : inner;
    int64_t row = rb * box.rows_per_chunk;
    const int64_t row_end = row + box.rows_per_chunk < box.rows
                                ? row + box.rows_per_chunk : box.rows;
    // The counter of the row's column 0, and the row's multi-index.
    uint64_t c = (uint64_t)box.start[last];
    int64_t idx[MAX_RANK];
    int64_t rem = row;
#pragma unroll
    for (int d = MAX_RANK - 2; d >= 0; --d) {
      if (d < last) {
        const int64_t q = rem / box.size[d];
        idx[d] = rem - q * box.size[d];
        c += (uint64_t)(box.start[d] + idx[d]) * (uint64_t)box.stride[d];
        rem = q;
      }
    }
    for (; row < row_end; ++row) {
      T* dst = out + row * inner;
      for (int64_t col = c0 + lane; col < c1; col += 32) {
        const uint32_t m =
            (threefry::bits(k0, k1, c + (uint64_t)col) >> SHIFT) & MASK;
        if constexpr (SMEM_TABLE) {
          __stcs(dst + col, t[m]);
        } else {
          __stcs(dst + col, __ldg(table + m));
        }
      }
#pragma unroll
      for (int d = MAX_RANK - 2; d >= 0; --d) {  // the next row
        if (d < last) {
          c += (uint64_t)box.stride[d];
          if (++idx[d] < box.size[d]) break;
          idx[d] = 0;
          c -= (uint64_t)box.size[d] * (uint64_t)box.stride[d];
        }
      }
    }
  }
}

int grid_blocks(long long size) {
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (size + THREADS - 1) / THREADS;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 8;
  return (int)(want < cap ? want : cap);
}

}  // namespace

extern "C" int normal_consts_count() { return N_CONSTS; }

extern "C" int normal_table_size() { return TABLE_SIZE; }

// table[m] = the normal draw of every word whose top 23 bits are m.
extern "C" int normal_table_launch(const float* consts, float* table,
                                   void* stream) {
  normal_table_kernel<<<TABLE_SIZE / THREADS, THREADS, 0,
                        (cudaStream_t)stream>>>(consts, table);
  return (int)cudaGetLastError();
}

// out[i] = normal draw i of key (k0, k1), i in [0, size), read from the
// table.
extern "C" int normal_launch(uint32_t k0, uint32_t k1, const float* table,
                             float* out, long long size, void* stream) {
  if (size <= 0) return 0;
  normal_kernel<<<grid_blocks(size), THREADS, 0, (cudaStream_t)stream>>>(
      k0, k1, table, out, (int64_t)size);
  return (int)cudaGetLastError();
}

// out[i] = bfloat16 normal draw i of key (k0, k1), i in [0, size), from
// the 128-entry bfloat16 table.
extern "C" int normal_bf16_launch(uint32_t k0, uint32_t k1,
                                  const uint16_t* table, uint16_t* out,
                                  long long size, void* stream) {
  if (size <= 0) return 0;
  normal_bf16_kernel<<<grid_blocks(size), THREADS, 0,
                       (cudaStream_t)stream>>>(k0, k1, table, out,
                                               (int64_t)size);
  return (int)cudaGetLastError();
}

extern "C" int normal_window_max_rank() { return MAX_RANK; }

// out (the box's sizes, row-major) = the box (starts, sizes) of the
// normal draw of key (k0, k1) of the whole shape, from the float32 table
// (bf16 = 0) or the 128-entry bfloat16 table (bf16 = 1).  shape, starts
// and sizes are host arrays of rank int64s; every size > 0 and the box
// inside the shape, as kernels/normal.py checks.
extern "C" int normal_window_launch(uint32_t k0, uint32_t k1,
                                    const void* table, void* out, int bf16,
                                    int rank, const long long* shape,
                                    const long long* starts,
                                    const long long* sizes, void* stream) {
  if (rank < 1 || rank > MAX_RANK) return (int)cudaErrorInvalidValue;
  Box box;
  box.rank = rank;
  long long stride = 1, rows = 1;
  for (int d = rank - 1; d >= 0; --d) {
    box.stride[d] = stride;
    box.start[d] = starts[d];
    box.size[d] = sizes[d];
    if (sizes[d] <= 0) return 0;
    stride *= shape[d];
    if (d < rank - 1) rows *= sizes[d];
  }
  const long long inner = sizes[rank - 1];
  box.rows = rows;
  box.col_blocks = (inner + WINDOW_CHUNK - 1) / WINDOW_CHUNK;
  box.rows_per_chunk = inner < WINDOW_CHUNK ? WINDOW_CHUNK / inner : 1;
  box.chunks = (rows + box.rows_per_chunk - 1) / box.rows_per_chunk *
               box.col_blocks;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (box.chunks + WARPS - 1) / WARPS;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 8;
  const int grid = (int)(want < cap ? want : cap);
  if (bf16) {
    normal_window_kernel<uint16_t, 1, 127u, true>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            k0, k1, (const uint16_t*)table, (uint16_t*)out, box);
  } else {
    normal_window_kernel<float, 9, 0x7FFFFFu, false>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            k0, k1, (const float*)table, (float*)out, box);
  }
  return (int)cudaGetLastError();
}
