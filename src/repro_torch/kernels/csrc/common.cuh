// Shared device helpers of the client-batched GP kernels (gp_score.cu,
// gp_grad.cu).  All arithmetic is f32; every block owns one (client,
// candidate tile) pair and loops over the trajectory itself, so no sum is
// carried between blocks.
#pragma once

#include <cuda_runtime.h>

namespace fz {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Dynamic shared memory above this needs an explicit opt-in per kernel.
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy the block's BN candidate rows (BN x d) into shared memory and store
// their squared norms in sn1.
template <int BN>
__device__ void load_cands(const float* __restrict__ c, int d, float* sc, float* sn1) {
  for (int i = threadIdx.x; i < BN * d; i += blockDim.x) sc[i] = c[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < BN; i += kWarps) {
    float s = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float v = sc[i * d + k];
      s += v * v;
    }
    s = warp_sum(s);
    if (lane == 0) sn1[i] = s;
  }
  __syncthreads();
}

// SE kernel-vector tile for trajectory rows t0 .. t0+len-1:
//   sh[i*ld + r]  = exp(-max(|c_i|^2 + |x_t|^2 - 2 c_i.x_t, 0) * inv_two_l2)
//   scr[i*ld + r] = c_i.x_t            (skipped when scr is null)
// with t = t0 + r.  One warp per trajectory row: the lanes read the row
// coalesced and keep BN partial dot products, then reduce by shuffles.
// The caller synchronises before reading sh / scr.
template <int BN>
__device__ void h_tile(const float* sc, const float* sn1, const float* __restrict__ x, int d,
                       int t0, int len, float inv_two_l2, float* sh, float* scr, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < len; r += kWarps) {
    const float* xr = x + (size_t)(t0 + r) * d;
    float dot[BN];
#pragma unroll
    for (int i = 0; i < BN; ++i) dot[i] = 0.f;
    float n2 = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float xv = xr[k];
      n2 += xv * xv;
#pragma unroll
      for (int i = 0; i < BN; ++i) dot[i] += sc[i * d + k] * xv;
    }
    n2 = warp_sum(n2);
#pragma unroll
    for (int i = 0; i < BN; ++i) {
      const float cr = warp_sum(dot[i]);
      if (lane == 0) {
        const float d2 = fmaxf(sn1[i] + n2 - 2.f * cr, 0.f);
        sh[i * ld + r] = expf(-d2 * inv_two_l2);
        if (scr != nullptr) scr[i * ld + r] = cr;
      }
    }
  }
}

// Sum acc[i] over the block; thread 0 receives the totals in tot (the
// other threads get 0).  red holds kWarps * BN floats of shared memory.
template <int BN>
__device__ void block_sum(float (&acc)[BN], float* red, float (&tot)[BN]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < BN; ++i) {
    const float v = warp_sum(acc[i]);
    if (lane == 0) red[warp * BN + i] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BN; ++i) {
    float s = 0.f;
    if (threadIdx.x == 0) {
      for (int w = 0; w < kWarps; ++w) s += red[w * BN + i];
    }
    tot[i] = s;
  }
}

}  // namespace fz

// Block sizes the wrappers may ask for (kernels/autotune.py keeps the same list).
#define FZ_DISPATCH_BN(bn, FN, ...)            \
  switch (bn) {                                \
    case 1: return FN<1>(__VA_ARGS__);         \
    case 2: return FN<2>(__VA_ARGS__);         \
    case 4: return FN<4>(__VA_ARGS__);         \
    case 8: return FN<8>(__VA_ARGS__);         \
    case 16: return FN<16>(__VA_ARGS__);       \
    default: return (int)cudaErrorInvalidValue; \
  }
