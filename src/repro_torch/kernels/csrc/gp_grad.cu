// Derived-GP gradient mean (paper eq. 5) on Hopper, client-batched and
// single-client.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/gp_grad.py  grad_mean_clients_kernel        (resident)
//   repro/kernels/gp_grad.py  grad_mean_tiled_clients_kernel  (cap-tiled)
//   repro/kernels/gp_grad.py  grad_mean_kernel                (single client)
//   repro/kernels/gp_grad.py  grad_mean_tiled_kernel          (single, cap-tiled)
// and computes, per query point c of client b,
//   grad_mu(c) = ( (h o alpha) @ X - (h . alpha) c ) / l^2,
//   h_t = exp(-|c - x_t|^2 / 2 l^2),
// with the validity mask already folded into alpha (padded slots carry
// alpha == 0 and contribute exactly zero).
//
// What bounds it on the card: bytes.  A launch reads N (cap d + cap + n d)
// floats and does about 4 N n cap d flops; on the main path n = 1, so it is
// a per-client GEMV over the trajectory (about 1.2 MB at N=5, cap=192,
// d=300: a third of a microsecond at full HBM rate).  With n = 1 the grid
// is only N blocks, so the launch latency and one SM's share of the
// bandwidth dominate; the design reads X twice per block (once for h, once
// for the product; the second pass mostly hits L2) and keeps w = h o alpha
// in shared memory so that nothing of size cap ever goes to HBM.  The
// single-client entries at n = 1 (the per-client engine) read a fifth of
// those bytes (0.07 us at full rate) in one block: latency-bound.
//
//  * resident: w for the whole trajectory (BN x cap) stays in shared memory.
//  * tiled: bc trajectory rows at a time; the (BN x d) product and the
//    (BN) sum accumulate in shared memory across tiles, so shared memory
//    does not grow with cap.
#include "common.cuh"

namespace fz {

// sw[i*ld + r] *= alpha[t0 + r] for the len rows of the tile, then
// ss[i] += sum_r sw[i*ld + r].  Ends synchronised.
template <int BN>
__device__ void weight_tile(float* sw, int ld, int len, const float* __restrict__ alpha, int t0,
                            float* ss) {
  for (int e = threadIdx.x; e < BN * len; e += blockDim.x) {
    const int i = e / len, r = e - i * len;
    sw[i * ld + r] *= alpha[t0 + r];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < BN; i += kWarps) {
    float s = 0.f;
    for (int r = lane; r < len; r += 32) s += sw[i * ld + r];
    s = warp_sum(s);
    if (lane == 0) ss[i] += s;
  }
  __syncthreads();
}

// acc[i*d + k] (+)= sum_r sw[i*ld + r] x[t0 + r][k] for the columns k this
// thread owns.
template <int BN>
__device__ void product_tile(const float* sw, int ld, int len, const float* __restrict__ x,
                             int t0, int d, float* acc, bool first) {
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    float a[BN];
#pragma unroll
    for (int i = 0; i < BN; ++i) a[i] = first ? 0.f : acc[i * d + k];
    for (int r = 0; r < len; ++r) {
      const float xv = x[(size_t)(t0 + r) * d + k];
#pragma unroll
      for (int i = 0; i < BN; ++i) a[i] += sw[i * ld + r] * xv;
    }
#pragma unroll
    for (int i = 0; i < BN; ++i) acc[i * d + k] = a[i];
  }
}

// out[i][k] = (acc[i][k] - s_i c_i[k]) / l^2 for the columns this thread owns.
template <int BN>
__device__ void grad_store(const float* acc, const float* ss, const float* sc, float* out, int d,
                           float inv_l2) {
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
#pragma unroll
    for (int i = 0; i < BN; ++i)
      out[(size_t)i * d + k] = (acc[i * d + k] - ss[i] * sc[i * d + k]) * inv_l2;
  }
}

// grid (n / BN, N); shared: c tile, |c|^2, w over the whole cap, the sums,
// and the (BN x d) product.
template <int BN>
__global__ void __launch_bounds__(kThreads)
grad_resident_kernel(const float* __restrict__ c, const float* __restrict__ x,
                     const float* __restrict__ alpha, float* __restrict__ out, int n, int cap,
                     int d, float inv_two_l2, float inv_l2) {
  extern __shared__ float smem[];
  __shared__ float ss[BN];
  float* sc = smem;
  float* sn1 = sc + BN * d;
  float* sw = sn1 + BN;
  float* sacc = sw + BN * cap;
  const int cl = blockIdx.y, row0 = blockIdx.x * BN;
  const float* xb = x + (size_t)cl * cap * d;

  if (threadIdx.x < BN) ss[threadIdx.x] = 0.f;
  load_cands<BN>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);
  h_tile<BN>(sc, sn1, xb, d, 0, cap, inv_two_l2, sw, nullptr, cap);
  __syncthreads();
  weight_tile<BN>(sw, cap, cap, alpha + (size_t)cl * cap, 0, ss);
  product_tile<BN>(sw, cap, cap, xb, 0, d, sacc, true);
  grad_store<BN>(sacc, ss, sc, out + ((size_t)cl * n + row0) * d, d, inv_l2);
}

// grid (n / BN, N); shared: c tile, |c|^2, one (BN x bc) w tile, the sums
// and the (BN x d) running product.
template <int BN>
__global__ void __launch_bounds__(kThreads)
grad_tiled_kernel(const float* __restrict__ c, const float* __restrict__ x,
                  const float* __restrict__ alpha, float* __restrict__ out, int n, int cap,
                  int d, int bc, float inv_two_l2, float inv_l2) {
  extern __shared__ float smem[];
  __shared__ float ss[BN];
  float* sc = smem;
  float* sn1 = sc + BN * d;
  float* sw = sn1 + BN;
  float* sacc = sw + BN * bc;
  const int cl = blockIdx.y, row0 = blockIdx.x * BN;
  const float* xb = x + (size_t)cl * cap * d;
  const float* ab = alpha + (size_t)cl * cap;

  if (threadIdx.x < BN) ss[threadIdx.x] = 0.f;
  load_cands<BN>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);
  for (int t0 = 0; t0 < cap; t0 += bc) {
    h_tile<BN>(sc, sn1, xb, d, t0, bc, inv_two_l2, sw, nullptr, bc);
    __syncthreads();
    weight_tile<BN>(sw, bc, bc, ab, t0, ss);
    product_tile<BN>(sw, bc, bc, xb, t0, d, sacc, t0 == 0);
    __syncthreads();  // the next tile overwrites sw
  }
  grad_store<BN>(sacc, ss, sc, out + ((size_t)cl * n + row0) * d, d, inv_l2);
}

template <typename K>
int prepare_grad(K kernel, size_t smem) {
  if (smem <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int BN>
int launch_grad_resident(const float* c, const float* x, const float* alpha, float* out, int nb,
                         int n, int cap, int d, float inv_two_l2, float inv_l2,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)BN * d + BN + (size_t)BN * cap);
  if (int e = prepare_grad(grad_resident_kernel<BN>, smem)) return e;
  dim3 grid(n / BN, nb);
  grad_resident_kernel<BN><<<grid, kThreads, smem, stream>>>(c, x, alpha, out, n, cap, d,
                                                             inv_two_l2, inv_l2);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_grad_tiled(const float* c, const float* x, const float* alpha, float* out, int nb,
                      int n, int cap, int d, int bc, float inv_two_l2, float inv_l2,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)BN * d + BN + (size_t)BN * bc);
  if (int e = prepare_grad(grad_tiled_kernel<BN>, smem)) return e;
  dim3 grid(n / BN, nb);
  grad_tiled_kernel<BN><<<grid, kThreads, smem, stream>>>(c, x, alpha, out, n, cap, d, bc,
                                                          inv_two_l2, inv_l2);
  return (int)cudaGetLastError();
}

}  // namespace fz

// C interface (bound with ctypes by kernels/loader.py).  Shapes: c (nb, n, d),
// x (nb, cap, d), alpha (nb, cap), out (nb, n, d); n % bn == 0 and, for the
// tiled route, cap % bc == 0.  Returns the cudaError_t of the launch.
extern "C" int fz_grad_resident(const float* c, const float* x, const float* alpha, float* out,
                                int nb, int n, int cap, int d, int bn, float inv_two_l2,
                                float inv_l2, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_grad_resident, c, x, alpha, out, nb, n, cap, d, inv_two_l2,
                 inv_l2, (cudaStream_t)stream)
}

extern "C" int fz_grad_tiled(const float* c, const float* x, const float* alpha, float* out,
                             int nb, int n, int cap, int d, int bn, int bc, float inv_two_l2,
                             float inv_l2, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_grad_tiled, c, x, alpha, out, nb, n, cap, d, bc, inv_two_l2,
                 inv_l2, (cudaStream_t)stream)
}

// Single-client entries: the client body above launched with one client
// (grid (n / bn, 1)).  Shapes: c (n, d), x (cap, d), alpha (cap), out (n, d).
extern "C" int fz_grad_single_resident(const float* c, const float* x, const float* alpha,
                                       float* out, int n, int cap, int d, int bn,
                                       float inv_two_l2, float inv_l2, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_grad_resident, c, x, alpha, out, 1, n, cap, d, inv_two_l2,
                 inv_l2, (cudaStream_t)stream)
}

extern "C" int fz_grad_single_tiled(const float* c, const float* x, const float* alpha,
                                    float* out, int n, int cap, int d, int bn, int bc,
                                    float inv_two_l2, float inv_l2, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_grad_tiled, c, x, alpha, out, 1, n, cap, d, bc, inv_two_l2,
                 inv_l2, (cudaStream_t)stream)
}
