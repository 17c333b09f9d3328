// RFF gradient contraction on Hopper (B5), with per-row weights:
//
//   G[i] = grad phi(x_i)^T w_i = -sqrt(2/M) sum_m sin(x_i . v_m + b_m) w_i[m] v_m,
//   x (n, d), v (M, d), b (M,), w_i = ws[i * w_stride ..] -> (n, d).
//
// w_stride = M gives the per-row form of the client-batched engine (row i
// is client i's iterate with its own w); w_stride = 0 gives the
// reference's one-w form.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/rff_grad.py  rff_grad_kernel
// which keeps each (bn, bm) sine tile in VMEM and accumulates the (bn, d)
// output across the sequential M grid axis.  Hopper's blocks run in no
// order, so the M reduction cannot be carried from block to block; one B5
// call is two device kernels instead:
//
//   1. S = sin(X V^T + b) o W  (n, M), the product of proj.cuh (its rows
//      kernel for n <= 16: one warp per feature, the lanes over d) with the
//      sine and the weight fused into the store: the projection comes as a
//      compensated pair hi + lo, the phase is added exactly and
//      sin(hi + lo) taken as sin(hi) + cos(hi) lo;
//   2. G = -sqrt(2/M) S V, one block per 32 output columns and 8 rows, its
//      1024 threads 32 columns x 32 groups of m; each group sums its m in
//      order (S staged in shared memory) as a compensated pair, and the 32
//      pairs are summed in a fixed order in shared memory.  No float
//      atomics: the same bits on every run.
//
// The engine takes the difference of two such calls (eq. 8, on w_global
// and on w_local); each call is rounded once at its end (S's storage
// aside), where the plain version rounds the phase, the sine's argument,
// every product and every partial sum.
//
// What bounds it on the card: bytes, and launch latency in practice.  At
// the main path's n = N = 5, M = 512, d = 300 the call must read V (614 KB),
// 0.19 us at 3.35 TB/s, for 3 MFLOP; S is 10 KB (40 KB at n = 10, M = 1000)
// and its round trip through device memory, which the TPU kernel avoids,
// costs nothing measurable next to V.  sincosf (not __sincosf): see
// rff_features.cu.
#include "proj.cuh"

namespace fz {

struct SinWeightEpilogue {
  const float* b;
  const float* w;
  int w_stride;
  __device__ float operator()(F2 proj, int i, int j, F2, F2) const {
    const F2 t = add_f(proj, b[j]);
    float s, c;
    sincosf(t.hi, &s, &c);
    return fmaf(c, t.lo, s) * w[(size_t)i * w_stride + j];
  }
};

constexpr int kGradRows = 8;      // rows of G a block owns
constexpr int kGradGroups = 32;   // groups of m summed in parallel
constexpr int kGradChunk = 1024;  // columns of S staged in shared memory at a time
constexpr int kGradThreads = 32 * kGradGroups;

// grid (ceil(d / 32), ceil(n / kGradRows)); kGradThreads threads, 32
// output columns x kGradGroups groups of m.  The block's rows of S are
// staged in shared memory a chunk at a time (read by every group as a
// broadcast), so the inner loop issues one global load (a coalesced row
// segment of V) per kGradRows compensated products.
__global__ void __launch_bounds__(kGradThreads)
rff_grad_reduce_kernel(const float* __restrict__ s, const float* __restrict__ v,
                       float* __restrict__ out, int n, int m, int d, float neg_scale) {
  // one buffer: first the S chunks (kGradRows x kGradChunk), then the
  // groups' partial sums (kGradGroups x kGradRows x 33), hi parts then lo
  constexpr int kBuf = kGradGroups * kGradRows * 33;
  static_assert(kGradRows * kGradChunk <= kBuf, "S chunk must fit the buffer");
  __shared__ float buf[kBuf];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane, row0 = blockIdx.y * kGradRows;
  const int nr = min(kGradRows, n - row0);
  F2 acc[kGradRows];
#pragma unroll
  for (int r = 0; r < kGradRows; ++r) acc[r] = F2{0.f, 0.f};
  for (int m0 = 0; m0 < m; m0 += kGradChunk) {
    const int len = min(kGradChunk, m - m0);
    for (int e = threadIdx.x; e < kGradRows * kGradChunk; e += kGradThreads) {
      const int r = e / kGradChunk, j = e - r * kGradChunk;
      buf[e] = (r < nr && j < len) ? s[(size_t)(row0 + r) * m + m0 + j] : 0.f;
    }
    __syncthreads();
    if (col < d) {
#pragma unroll 4
      for (int j = g; j < len; j += kGradGroups) {
        const float vv = v[(size_t)(m0 + j) * d + col];
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) dot2_step(buf[r * kGradChunk + j], vv, acc[r]);
      }
    }
    __syncthreads();  // the next chunk (or the partials) overwrite buf
  }
  // threads (r, lane) for r < kGradRows sum the groups' pairs in order:
  // the hi parts by TwoSum (their errors kept), then the lo parts
  const int r = g;
  const bool owner = r < nr && col < d;
  float hi = 0.f, lo = 0.f;
#pragma unroll
  for (int q = 0; q < kGradRows; ++q) buf[(g * kGradRows + q) * 33 + lane] = acc[q].hi;
  __syncthreads();
  if (owner) {
    for (int q = 0; q < kGradGroups; ++q) {
      float e;
      two_sum(hi, buf[(q * kGradRows + r) * 33 + lane], hi, e);
      lo = __fadd_rn(lo, e);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kGradRows; ++q) buf[(g * kGradRows + q) * 33 + lane] = acc[q].lo;
  __syncthreads();
  if (owner) {
    for (int q = 0; q < kGradGroups; ++q)
      lo = __fadd_rn(lo, buf[(q * kGradRows + r) * 33 + lane]);
    out[(size_t)(row0 + r) * d + col] = neg_scale * __fadd_rn(hi, lo);
  }
}

}  // namespace fz

// C interface (bound with ctypes by kernels/loader.py).  `s` is (n, m)
// scratch the wrapper allocates; `scale` is sqrt(2/M) of the true M.
// Returns the cudaError_t of the first failing launch, else 0.
extern "C" int fz_rff_grad(const float* x, const float* v, const float* b, const float* w,
                           float* s, float* out, int n, int m, int d, int w_stride, float scale,
                           void* stream) {
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (int e = fz::launch_proj<false>(x, v, s, 1, n, m, d,
                                     fz::SinWeightEpilogue{b, w, w_stride}, st))
    return e;
  dim3 grid((d + 31) / 32, (n + fz::kGradRows - 1) / fz::kGradRows);
  fz::rff_grad_reduce_kernel<<<grid, fz::kGradThreads, 0, st>>>(s, v, out, n, m, d, -scale);
  return (int)cudaGetLastError();
}
