// sketch_gram_sjlt on Hopper: the fused SJLT (OSNAP) -> survivor-masked
// Gram, G = (1 / max(sum m, 1)) sum_k m_k (S_k^T A)^T (S_k^T A) with
// S_k^T A = (1 / sqrt(s)) sum_t (signed segment-sum of layer t).
//
// Replaces the Pallas kernel src/repro/kernels/sketch_gram.py
// (sketch_gram_sjlt through _sketch_gram with the s-layer _encode_count),
// which sums s signed one-hot layers into one (tile_n x b) encode matrix in
// VMEM and runs it through the matrix unit.
//
// Bound on the H100: at the main path's shapes (K = 150, 30 masked, s = 4,
// n = 300,000, d = 3,000, b = 256) the Gram's b d (d + 1) operations per
// live block and the apply's 2 s n d are fp32 work against ~4 GB of input:
// bound by the fp32 rate, 17 ms.  In practice the apply bounds it: 4.3e11
// updates, s times the count sketch's.  Held in a shared-memory tile, each
// is a shared load and store, and one panel of A serves only the few
// blocks a CTA's tiles hold.  Design: the sorted gather of
// sketch_common.cuh, as count_sketch.cu says, with the (row, layer) entries
// of all s layers sorted into one list per bucket; a warp sums its
// bucket's list in registers, so two layers of one row that land in one
// bucket add twice, as the reference's slot-summed segment_sum adds them,
// and the 1/sqrt(s) scale is applied once at write-out.  A's K s re-reads
// come from L2.
#include "sketch_common.cuh"

extern "C" int sketch_gram_sjlt_launch(const int* h, const float* sigma,
                                       const float* a, const float* mask,
                                       float* g, float* scratch,
                                       uint32_t* iscratch, float* gscratch,
                                       int k, int s, int n, int d, int b,
                                       int chunk, int slices, int chunks,
                                       int width, float scale, void* stream) {
  return (int)sketch::launch_sketch_gram(
      h, sigma, a, mask, g, scratch, iscratch, gscratch, k, s, n, d, b,
      chunk, slices, {chunks, width}, scale, (cudaStream_t)stream);
}
