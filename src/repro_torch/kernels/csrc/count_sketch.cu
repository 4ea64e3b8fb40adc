// count_sketch_apply on Hopper: A_tilde_k = S_k^T A for all K blocks, and
// with s > 1 layers per block (h and sigma (K, s, n)) the SJLT apply
// A_tilde_k = (1 / sqrt(s)) sum_t S_kt^T A.
//
// Replaces the Pallas kernel src/repro/kernels/count_sketch.py
// (count_sketch_apply), which builds a signed one-hot (tn x b) matrix and
// runs it through the TPU's matrix unit because the TPU has no scatter.
//
// Bound on the H100: the function is a signed scatter-add, 2 K s n d fp32
// operations against one read of A (n d floats) and the codes; at the
// distributed-avg shapes (K = 10, s = 1 or 4, n = 300,000, d = 3,000,
// b = 4,096) it is bound by the bytes, ~1.2 ms.  What bounds a segment sum
// on this card is where its partial sums live: a shared-memory tile per
// block holds them only for small b, and even there each update is a
// shared load and store.  Design (sketch_common.cuh): a stable counting
// sort of each block's (row, layer) entries by bucket on the device (int
// atomics for the counts only), then a warp per output row (block, bucket)
// and 32-column strip sums sigma times its bucket's rows of A in registers
// and writes the row once.  The grid walks A strip by strip, so its K s
// re-reads come from L2 and A comes from HBM about once: the apply is bound
// by L2 bandwidth, at every b.  The host sizes the sort and the scratch
// (kernels/count_sketch.py, apply_plan).
#include "sketch_common.cuh"

// `chunks` sort chunks per block, `width` columns per strip; scratch holds
// apply_plan's scratch_ints int32 words.
extern "C" int count_sketch_apply_launch(const int* h, const float* sigma,
                                         const float* a, float* out,
                                         uint32_t* scratch, int k, int s,
                                         int n, int d, int b, int chunks,
                                         int width, float scale,
                                         void* stream) {
  return (int)sketch::launch_cs_apply(h, sigma, a, out, scratch, k, s, n, d,
                                      b, {chunks, width},
                                      s == 1 ? 1.f : scale,
                                      (cudaStream_t)stream);
}
