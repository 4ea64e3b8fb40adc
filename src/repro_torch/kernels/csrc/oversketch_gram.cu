// oversketch_gram on Hopper: G = (1 / max(sum m, 1)) sum_k m_k A_k^T A_k
// from a materialized A_tilde (K, b, d).
//
// Replaces the Pallas kernel src/repro/kernels/oversketch_matmul.py
// (oversketch_gram), a (d_i, d_j, K * b_tiles) grid of matrix-unit tiles
// whose survivor mask is applied inside the accumulation.
//
// Bound on the H100: 2 K b d^2 fp32 operations against K b d reads, so it
// is bound by the fp32 FFMA pipe (no tensor cores: the reference is IEEE
// fp32); G is symmetric, so only the upper triangle of 128 x 128 tiles is
// computed.  At the paths' shapes (120 live blocks of b = 256, d = 3,000)
// that is 300 tiles, which as one CTA each fill 1.14 waves of the 264 CTAs
// an H100 holds (57% of the card busy at best).  The design
// (sketch_common.cuh, launch_gram) therefore cuts the live rows into
// slices sized at run time from the SM count so that tile x slice work
// items fill whole waves, feeds each CTA's FFMAs from a 3-stage cp.async
// ring with 16-byte fragment loads, and sums the slices' partial tiles in a
// fixed order in a second kernel that also mirrors each tile into its
// transpose.  A masked block's rows are never read.
#include "sketch_common.cuh"

extern "C" int oversketch_gram_launch(const float* at, const float* mask,
                                      float* g, float* gscratch, int k, int b,
                                      int d, int slices, void* stream) {
  return (int)sketch::launch_gram(at, mask, g, gscratch, 0, k, k, b, d,
                                  slices, 0, 1, (cudaStream_t)stream);
}
