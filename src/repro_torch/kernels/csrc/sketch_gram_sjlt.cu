// sketch_gram_sjlt on Hopper: the fused SJLT (OSNAP) -> survivor-masked
// Gram, G = (1 / max(sum m, 1)) sum_k m_k (S_k^T A)^T (S_k^T A) with
// S_k^T A = (1 / sqrt(s)) sum_t (signed segment-sum of layer t).
//
// Replaces the Pallas kernel src/repro/kernels/sketch_gram.py
// (sketch_gram_sjlt through _sketch_gram with the s-layer _encode_count),
// which sums s signed one-hot layers into one (tile_n x b) encode matrix in
// VMEM and runs it through the matrix unit.
//
// Bound on the H100: at the main path's shapes (K = 150, s = 4,
// n = 300,000, d = 3,000, b = 256) the Gram's b d (d + 1) operations per
// live block (its distinct entries) and the apply's 2 s n d are both
// fp32 work against ~4 GB of input: bound by the fp32 FFMA rate.  Design:
// the count-sketch design of sketch_gram.cu with a loop over the s layers
// into the same (b x 32) shared-memory tile (sketch_common.cuh).  The warp
// that owns a block adds its layers one after another and each lane owns
// one column, so two layers of one row that land in the same bucket add
// as the reference's slot-summed segment_sum adds them; the 1/sqrt(s)
// scale is applied once when the tile is written out.  Each staged pass
// carries s layers of codes, so a CTA holds 5 blocks at b = 256 (6 for
// the count sketch), and the apply does s times the count sketch's updates.
#include "sketch_common.cuh"

extern "C" int sketch_gram_sjlt_blocks_per_cta(int b, int s) {
  return sketch::cs_blocks_per_cta(b, s);
}

extern "C" int sketch_gram_sjlt_launch(const int* h, const float* sigma,
                                       const float* a, const float* mask,
                                       float* g, float* scratch, int k,
                                       int s, int n, int d, int b, int chunk,
                                       float scale, void* stream) {
  return (int)sketch::launch_sketch_gram(h, sigma, a, mask, g, scratch, k, s,
                                         n, d, b, chunk, scale,
                                         (cudaStream_t)stream);
}
