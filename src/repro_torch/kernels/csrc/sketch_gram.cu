// sketch_gram_count on Hopper: the fused count-sketch -> survivor-masked
// Gram, G = (1 / max(sum m, 1)) sum_k m_k (S_k^T A)^T (S_k^T A).
//
// Replaces the Pallas kernel src/repro/kernels/sketch_gram.py
// (sketch_gram_count through _sketch_gram, _kernel_single, _kernel_tiled
// and _encode_count).  On the TPU each (d_tile x d_tile) output tile keeps
// its (b x d_tile) A_tilde panels in VMEM and re-encodes A per tile pair.
// On Hopper that tiling would re-read A for every one of ~500 tile pairs
// and 150 blocks, since 227 KB of shared memory holds a (256 x d_tile)
// panel only for d_tile near 100.
//
// Bound on the H100: at the main path's shapes (K = 150, n = 300,000,
// d = 3,000, b = 256) the Gram's 2 K b d^2 fp32 operations dominate the
// apply's 2 K n d, against about 4 GB of input: it is bound by the fp32
// FFMA rate.  Design: sort every live block's codes by bucket once, then
// walk the blocks in chunks of at most the wrapper's CHUNK_BYTES (all 150
// blocks at those shapes); for each chunk the sorted gather of
// sketch_common.cuh (grouped at b = 256: a row of A's strip read once into
// shared memory for four live blocks) writes the live blocks' A_tilde
// into a scratch buffer
// and the masked Gram of sketch_common.cuh (launch_gram, also behind
// oversketch_gram.cu) folds m_k A_k^T A_k into G (the first chunk
// overwrites G, the last divides by the survivor count).  A masked block
// is neither sketched nor read.
#include "sketch_common.cuh"

extern "C" int sketch_gram_count_launch(const int* h, const float* sigma,
                                        const float* a, const float* mask,
                                        float* g, float* scratch,
                                        uint32_t* iscratch, float* gscratch,
                                        int k, int n, int d, int b, int chunk,
                                        int slices, int chunks, int width,
                                        int group, void* stream) {
  return (int)sketch::launch_sketch_gram(
      h, sigma, a, mask, g, scratch, iscratch, gscratch, k, 1, n, d, b,
      chunk, slices, {chunks, width, group}, 1.f, (cudaStream_t)stream);
}
