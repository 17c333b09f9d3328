// Random Fourier features on Hopper (B6):
//
//   phi(X) = sqrt(2/M) cos(X V^T + b),   x (n, d), v (M, d), b (M,) -> (n, M).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/rff_features.py  rff_features_kernel
// which runs one MXU product per (bn, bm) output tile with d resident.
//
// What bounds it on the card: operations.  On the eq. 6 fit of the main
// path n = N cap = 960 rows, M = 512, d = 300: 2 n M d = 295 MFLOP, 4.40 us
// at 67 TFLOP/s, against 3.7 MB of traffic, 1.1 us at 3.35 TB/s.  The
// design is proj.cuh's tile kernel: 64 x 64 output tiles (120 blocks here),
// d staged by cp.async in chunks of 32, converted to f64 once as staged,
// and multiplied on the f64 tensor cores (mma.sync m16n8k4, 67 TFLOP/s,
// the rate of the bound), with the phase add and the cosine fused into the
// store, so X V^T never goes to device memory.  TF32 would break the 1e-4
// parity rule; f64 products of f32 inputs are exact, and the f64 sum is
// handed on as the pair hi + lo (proj.cuh).  The phase is added exactly
// and cos(hi + lo) taken as cos(hi) - sin(hi) lo, so the only roundings
// left are sincosf's and the scale's: the plain version's f32 rounding of
// a projection of 20-60 (a few 1e-7 of phase) is gone.  sincosf (not
// __sincosf): the intrinsic skips range reduction, and the projections
// reach tens.  Up to 16 rows take proj.cuh's rows kernel instead.
#include "proj.cuh"

namespace fz {

struct CosEpilogue {
  const float* b;
  float scale;
  __device__ float operator()(F2 proj, int, int j, F2, F2) const {
    const F2 t = add_f(proj, b[j]);
    float s, c;
    sincosf(t.hi, &s, &c);
    return scale * fmaf(-s, t.lo, c);
  }
};

}  // namespace fz

// C interface (bound with ctypes by kernels/loader.py); `scale` is
// sqrt(2/M) of the true M.  Returns the cudaError_t of the launch.
extern "C" int fz_rff_features(const float* x, const float* v, const float* b, float* out, int n,
                               int m, int d, float scale, void* stream) {
  return fz::launch_proj<false>(x, v, out, 1, n, m, d, fz::CosEpilogue{b, scale},
                                (cudaStream_t)stream);
}
