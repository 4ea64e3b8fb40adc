// oversketch_gram on Hopper: G = (1 / max(sum m, 1)) sum_k m_k A_k^T A_k
// from a materialized A_tilde (K, b, d).
//
// Replaces the Pallas kernel src/repro/kernels/oversketch_matmul.py
// (oversketch_gram), a (d_i, d_j, K * b_tiles) grid of matrix-unit tiles
// whose survivor mask is applied inside the accumulation.
//
// Bound on the H100: 2 K b d^2 fp32 operations against K b d reads, so it
// is bound by the fp32 FFMA rate (no tensor cores: the reference is IEEE
// fp32).  The kernel computes only the upper triangle of 128 x 128 output
// tiles (G is symmetric), which halves the operations, and mirrors each
// tile into its transpose.  Each CTA stages 8 x 128 slices of the two
// column strips in shared memory and keeps an 8 x 8 register micro-tile per
// thread; a masked block is skipped before any of its rows are read.
#include "sketch_common.cuh"

extern "C" int oversketch_gram_launch(const float* at, const float* mask,
                                      float* g, int k, int b, int d,
                                      void* stream) {
  return (int)sketch::launch_gram(at, mask, g, 0, k, k, b, d, 0, 1,
                                  (cudaStream_t)stream);
}
