// Derived-GP gradient mean (paper eq. 5) on Hopper, client-batched and
// single-client.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/gp_grad.py  grad_mean_clients_kernel        (resident)
//   repro/kernels/gp_grad.py  grad_mean_tiled_clients_kernel  (cap-tiled)
//   repro/kernels/gp_grad.py  grad_mean_kernel                (single client)
//   repro/kernels/gp_grad.py  grad_mean_tiled_kernel          (single, cap-tiled)
// and computes, per query point c of client b,
//   grad_mu(c) = ( (h o alpha) @ X - (h . alpha) c ) / l^2
//              = sum_t h_t alpha_t (x_t - c) / l^2,
//   h_t = exp(-|c - x_t|^2 / 2 l^2),
// with the validity mask already folded into alpha (padded slots carry
// alpha == 0 and contribute exactly zero).
//
// What bounds it on the card: bytes.  A launch reads N (cap d + cap + n d)
// floats and does about 4 N n cap d flops; on the main path n = 1, so it is
// a per-client GEMV over the trajectory (about 1.2 MB at N=5, cap=192,
// d=300: a third of a microsecond at full HBM rate).  Three kernels, routed
// by the wrapper (kernels/ops.py, kernels/autotune.py):
//  * client-batched resident (grad_cluster_kernel, the main path): one
//    thread block cluster per (client, candidate tile), each block owning
//    up to 32 trajectory rows, so X is read from HBM once, by N cap / 32
//    blocks (30 at the main path's shapes) instead of N; the blocks' partial
//    sums meet in distributed shared memory and are added in rank order (no
//    atomics).  f64 sums in the difference form make it more accurate than
//    its f32 plain version, whose two terms nearly cancel.  Its note is
//    above the kernel.
//  * resident, one block per (client, tile) (grad_resident_kernel: the
//    single-client entries): w = h o alpha for the whole trajectory
//    (BN x cap) in shared memory; the block reads X twice (the second pass
//    mostly hits L2).  At n = 1 one block: latency-bound.
//  * cap-tiled (grad_tiled_kernel: client-batched and single-client): bc
//    trajectory rows at a time; the (BN x d) product and the (BN) sum
//    accumulate in shared memory across tiles, so shared memory does not
//    grow with cap.
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


// ---- client-batched resident route: one cluster per (client, tile) ------
//
// grad_cluster_kernel: grid (cs * n / BN, N), clusters of cs blocks along x.
// Block `rank` of a cluster owns trajectory rows R = split_at(cap, cs, rank)
// and output columns split_at(d, cs, rank):
//  1. stage its rows of X (cp.async; X is read from HBM once per call);
//  2. the candidates in f64 ([k][BN]) and |c|^2;
//  3. w_t = h_t alpha_t for its rows, in f64 (rows_dot: warps split d,
//     lanes take rows).  On the engine's unshifted coordinates (|x|^2 ~ d/4)
//     the expanded distance cancels by 1e3-1e4, so h needs every product of
//     c.x exactly (f64 holds a product of two f32 values exactly);
//  4. its partial sum_{t in R} w_t (x_t - c) over all d columns, f64, one
//     thread per column: the difference form, whose terms are as small as
//     the distances (x_t - c is exact in f64), where (h o alpha) @ X and
//     (h . alpha) c nearly cancel;
//  5. cluster barrier; each block sums its output columns over the ranks'
//     partials in rank order (distributed shared memory) and writes them
//     scaled by 1 / l^2;
//  6. cluster barrier, so no block leaves while its partials are read.
// Shared memory (GradClusterSmem; kernels/autotune.py mirrors it): the
// candidates (d x BN, f64), |c|^2, w of the own rows (rmax x BN, f64), the
// own rows of X (rmax x rows_ld(d), f32) and one region used first for
// rows_dot's partials, then for the block's partial sums (BN x d, f64).
template <int BN>
__host__ __device__ size_t grad_cluster_union(int d) {
  const size_t a = 8 * (size_t)kWarps * 32 * (BN + 1), b = 8 * (size_t)BN * d;
  return a > b ? a : b;
}

template <int BN>
struct GradClusterSmem {
  double* sc;   // the candidates ([k][BN])
  double* sn1;  // |c|^2
  double* sw;   // w of the own rows ([r][BN])
  float* sx;    // the own rows of X (rmax x rows_ld(d))
  double* u;    // rows_dot's partials, then the block's partial sums ([i][k])
  __host__ __device__ GradClusterSmem(SmemCarve& m, int d, int rmax)
      : sc(m.take<double>((size_t)d * BN)),
        sn1(m.take<double>(BN)),
        sw(m.take<double>((size_t)rmax * BN)),
        sx(m.take<float>((size_t)rmax * rows_ld(d))),
        u(m.take<double>(grad_cluster_union<BN>(d) / 8)) {}
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
grad_cluster_kernel(const float* __restrict__ c, const float* __restrict__ x,
                    const float* __restrict__ alpha, float* __restrict__ out, int n, int cap,
                    int d, float inv_two_l2, float inv_l2) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cl = blockIdx.y, row0 = (blockIdx.x / cs) * BN;
  const int rmax = (cap + cs - 1) / cs, ldx = rows_ld(d);
  const int t0 = split_at(cap, cs, rank), rows = split_at(cap, cs, rank + 1) - t0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemCarve m{(uintptr_t)smem_raw};
  const GradClusterSmem<BN> sm(m, d, rmax);
  double *sc = sm.sc, *sn1 = sm.sn1, *sw = sm.sw, *part = sm.u;
  float* sx = sm.sx;

  stage_tile(sx, ldx, x + ((size_t)cl * cap + t0) * d, rows, d, d);
  cp_async_commit();
  load_cands_t<BN, double>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);
  cp_async_wait<0>();
  __syncthreads();
  const float* ab = alpha + (size_t)cl * cap + t0;
  rows_dot<BN, double>(sc, sx, ldx, d, rows, part, [&](int i, int r, double cr, double n2) {
    sw[r * BN + i] = exp(-fmax(sn1[i] + n2 - 2.0 * cr, 0.0) * (double)inv_two_l2) * (double)ab[r];
  });
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    double acc[BN], ck[BN];
#pragma unroll
    for (int i = 0; i < BN; ++i) {
      acc[i] = 0.0;
      ck[i] = sc[k * BN + i];
    }
    for (int r = 0; r < rows; ++r) {
      const double xv = (double)sx[(size_t)r * ldx + k];
#pragma unroll
      for (int i = 0; i < BN; ++i) acc[i] = fma(sw[r * BN + i], xv - ck[i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < BN; ++i) part[(size_t)i * d + k] = acc[i];
  }
  cluster.sync();  // every rank's partials are written
  const int k0 = split_at(d, cs, rank), kn = split_at(d, cs, rank + 1) - k0;
  for (int e = threadIdx.x; e < BN * kn; e += blockDim.x) {
    const int i = e / kn, k = k0 + (e - i * kn);
    double v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      v[q] = q < cs ? cluster.map_shared_rank(part, q)[(size_t)i * d + k] : 0.0;
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) s += v[q];
    out[((size_t)cl * n + row0 + i) * d + k] = (float)(s * (double)inv_l2);
  }
  cluster.sync();  // the other ranks have read this block's partials
}

template <int BN>
size_t grad_cluster_smem(int cap, int d, int cs) {
  SmemCarve m{0};
  (void)GradClusterSmem<BN>(m, d, (cap + cs - 1) / cs);
  return (size_t)m.p;
}

template <int BN>
int launch_cluster_grad(const float* c, const float* x, const float* alpha, float* out, int nb,
                        int n, int cap, int d, int cs, float inv_two_l2, float inv_l2,
                        cudaStream_t stream) {
  if (cs < 1 || cs > cap || cs > kMaxCluster) return (int)cudaErrorInvalidValue;
  dim3 grid(cs * (n / BN), nb);
  return launch_cluster(grad_cluster_kernel<BN>, grid, cs, grad_cluster_smem<BN>(cap, d, cs),
                        stream, c, x, alpha, out, n, cap, d, inv_two_l2, inv_l2);
}
}  // namespace fz

// C interface (bound with ctypes by kernels/loader.py).  Shapes: c (nb, n, d),
// x (nb, cap, d), alpha (nb, cap), out (nb, n, d); n % bn == 0 and, for the
// tiled route, cap % bc == 0.  Returns the cudaError_t of the launch.
extern "C" int fz_grad_resident(const float* c, const float* x, const float* alpha, float* out,
                                int nb, int n, int cap, int d, int bn, int cs, float inv_two_l2,
                                float inv_l2, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_cluster_grad, c, x, alpha, out, nb, n, cap, d, cs, inv_two_l2,
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
