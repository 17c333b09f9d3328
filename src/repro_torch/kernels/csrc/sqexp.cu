// Squared-exponential Gram on Hopper (B9), client-batched:
//
//   K[b][i][j] = exp(-max(|x1_i|^2 + |x2_j|^2 - 2 x1_i . x2_j, 0) / (2 l^2)),
//   x1 (N, a, d), x2 (N, c, d) -> (N, a, c);  a 2-D call is N = 1.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/sqexp.py  sqexp_kernel
// and keeps its EXPANDED distance with the clamp at 0 (not direct
// differences): the reference's padded Gram rounds exactly this way, and
// with it which append events fail the factor health check.
//
// What bounds it on the card.  At every append event of the main path
// (N = 5 clients, k = 5 new rows against cap = 192, d = 300): bytes, 1.2 MB
// of trajectory, 0.36 us at 3.35 TB/s, for 2.9 MFLOP; at the iterate's
// event (k = 1) 1.15 MB, 0.34 us.  At factor_init's (5, 192, 192) init
// Gram: operations, 112 MFLOP, 1.67 us at 67 TFLOP/s, against 3.0 MB.  The
// body is the product of proj.cuh with the row norms summed beside it and
// the distance, clamp and expf fused into the store, so neither the cross
// products nor the distances go to device memory.  An append event (k <=
// 16 new rows) takes its rows kernel: a block owns 8 ring rows of one
// client, copies them and the k new rows into shared memory by cp.async,
// all issued at once, sums the new rows' norms while the ring rows land,
// then one warp per ring row (the lanes over d) sums k + 1 compensated
// pairs, and k lanes apply the epilogue at once.  factor_init's cap x cap
// Gram takes the tile kernel, on the f64 tensor cores: 32 x 32 tiles there
// (180 blocks for the card's 132 SMs, where 64 x 64 makes 45), the norms
// summed in f64 from the f64 tiles as they are converted.
//
// Accuracy: the three terms of the expanded distance arrive as pairs
// (compensated f32 from the rows kernel, split f64 sums from the tile
// kernel; proj.cuh) and are combined by TwoSum, so the distance is rounded
// once, after the cancellation, where the plain f32 version rounds each
// term (about 1e-7 of |x|^2 each) before it.  Nearby points are the
// engine's case: the Gram rows of an append event compare new queries with
// a ring a few 1e-2 away, and feed a factor of condition 1e5.
#include "proj.cuh"

namespace fz {

struct SqexpEpilogue {
  float inv_two_l2;
  __device__ float operator()(F2 cross, int, int, F2 n1, F2 n2) const {
    float s1, e1, s2, e2;
    two_sum(n1.hi, n2.hi, s1, e1);
    two_sum(s1, -2.f * cross.hi, s2, e2);
    const float tail = __fadd_rn(__fadd_rn(e1, e2),
                                 __fadd_rn(__fadd_rn(n1.lo, n2.lo), -2.f * cross.lo));
    const float d2 = fmaxf(__fadd_rn(s2, tail), 0.f);
    return expf(-d2 * inv_two_l2);
  }
};

}  // namespace fz

// C interface (bound with ctypes by kernels/loader.py).  Shapes: x1 (nb, a, d),
// x2 (nb, c, d), out (nb, a, c); inv_two_l2 = 1 / (2 l^2).  Returns the
// cudaError_t of the launch.
extern "C" int fz_sqexp(const float* x1, const float* x2, float* out, int nb, int a, int c, int d,
                        float inv_two_l2, void* stream) {
  return fz::launch_proj<true>(x1, x2, out, nb, a, c, d, fz::SqexpEpilogue{inv_two_l2},
                               (cudaStream_t)stream);
}
