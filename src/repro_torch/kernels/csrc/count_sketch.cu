// count_sketch_apply on Hopper: A_tilde_k = S_k^T A for all K blocks.
//
// Replaces the Pallas kernel src/repro/kernels/count_sketch.py
// (count_sketch_apply), which builds a signed one-hot (tn x b) matrix and
// runs it through the TPU's matrix unit because the TPU has no scatter.
//
// Bound on the H100: the work is a signed scatter-add, 2 K n d fp32
// operations against K n d reads of A, so an ideal kernel reads A once and
// is bound by the operations.  Here each CTA owns a 32-column strip of A and
// as many sketch blocks as fit in its shared memory (6 at b = 256).  It
// copies 64-row panels of the strip and every live block's buckets and
// signs into shared memory with cp.async, double-buffered so that the next
// pass lands while the warps add this one, and each warp adds the rows
// into the (b x 32) tiles of the blocks it owns, eight rows at a time
// (sketch_common.cuh, cs_add_batch: no shared-memory atomics, which are a
// compare-and-swap loop for fp32 on sm_90).  A is re-read once per group of
// blocks and every update is a shared-memory load and store, so those
// re-reads and the warps' shared-memory round trips are the limit; a
// distributed-shared-memory cluster that holds more blocks per read of A is
// the way to lift it.  Past b ~ 1,680 one (b x 32) tile no longer fits
// beside the staged passes; a block's buckets are then split into ranges,
// one per warp, and the block spans a few CTAs that each re-read the strip
// (sketch_common.cuh, cs_plan).
//
// With s > 1 layers per block (h and sigma (K, s, n)) the same kernel is the
// SJLT apply: the layers add into one tile, scaled at write-out.
#include "sketch_common.cuh"

extern "C" int count_sketch_apply_launch(const int* h, const float* sigma,
                                         const float* a, float* out, int k,
                                         int s, int n, int d, int b,
                                         float scale, void* stream) {
  return (int)sketch::launch_cs_apply(h, sigma, a, nullptr, out, n, d, b, s,
                                      0, k, s == 1 ? 1.f : scale,
                                      (cudaStream_t)stream);
}
