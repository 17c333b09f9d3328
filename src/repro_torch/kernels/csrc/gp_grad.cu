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
// d=300: a third of a microsecond at full HBM rate).  What costs at these
// sizes is spreading a client's few hundred rows over the card and the
// latency of each step.  One kernel serves all four entries
// (grad_cluster_kernel): a thread block cluster per (client, candidate
// tile), each block owning a part of the trajectory, which it streams
// through shared memory in chunks, so X is read from HBM once per call and
// shared memory is bounded by the chunk.  The routes differ only in the
// geometry the wrapper gives (kernels/autotune.py grad_geometry):
//  * client-batched resident (B3, the main path): clusters of up to 8
//    blocks of at least 32 rows, each block's part in one chunk;
//  * single-client resident (B8a, the per-client engine): clusters of up
//    to 16 blocks (non-portable) of about 12 rows, one chunk;
//  * cap-tiled, client-batched and single-client (B4, B8b): the single-
//    client geometry for both, so one client's gradient is its row of a
//    client-batched call bit for bit, in chunks of at most block_cap rows
//    (double-buffered), at any cap.
// Every sum is f64 in a fixed order with no atomics, in the difference
// form, so a second launch gives the same bits and the kernel is more
// accurate than its f32 plain version, whose two terms nearly cancel.
#include "common.cuh"

namespace fz {

// grad_cluster_kernel: grid (cs * n / BN, N), clusters of cs blocks along x.
// Block `rank` of a cluster owns trajectory rows [t0, t0 + rows) =
// split_at(cap, cs, rank) and output columns split_at(d, cs, rank), and
// takes its rows in chunks of jc (two buffers when it has more than one):
//  1. stage chunks 0 and 1 of its rows of X (cp.async);
//  2. the candidates in f64 ([k][BN]) and |c|^2;
//  3. per chunk, w_t = h_t alpha_t for its rows, in f64 (rows_dot: warps
//     split d, lanes take rows).  On the engine's unshifted coordinates
//     (|x|^2 ~ d/4) the expanded distance cancels by 1e3-1e4, so h needs
//     every product of c.x exactly (f64 holds a product of two f32 values
//     exactly);
//  4. per chunk, its partial sum_t w_t (x_t - c) over all d columns, f64,
//     one thread per column, carried from chunk to chunk in shared memory:
//     the difference form, whose terms are as small as the distances
//     (x_t - c is exact in f64), where (h o alpha) @ X and (h . alpha) c
//     nearly cancel; chunk ch + 2 is staged while ch + 1 is worked on;
//  5. cluster barrier; each block sums its output columns over the ranks'
//     partials in rank order (distributed shared memory) and writes them
//     scaled by 1 / l^2;
//  6. cluster barrier, so no block leaves while its partials are read.
// A column's partial runs over the block's rows in ascending order however
// they are chunked, so jc changes no bit: the routes of one geometry give
// the same bits.

// Byte offsets of the shared-memory regions (kernels/autotune.py grad_smem
// mirrors them), and `bytes` in all: nbuf chunks of X (jc x rows_ld(d),
// f32), the candidates (d x BN, f64), |c|^2, w of a chunk (jc x BN, f64),
// rows_dot's partials (kWarps x 32 x (BN + 1), f64) and the block's partial
// sums (BN x d, f64).  Offsets, not pointers: a pointer the kernel derives
// from its shared array keeps the shared state space, so its loads are
// shared-memory loads.
struct GradClusterSmem {
  size_t sx, sc, sn1, sw, dots, part, bytes;
};

template <int BN>
__host__ __device__ inline GradClusterSmem grad_cluster_smem(int d, int jc, int nbuf) {
  SmemCarve m{0};
  GradClusterSmem s;
  s.sx = (size_t)m.take<float>((size_t)nbuf * jc * rows_ld(d));
  s.sc = (size_t)m.take<double>((size_t)d * BN);
  s.sn1 = (size_t)m.take<double>(BN);
  s.sw = (size_t)m.take<double>((size_t)jc * BN);
  s.dots = (size_t)m.take<double>((size_t)kWarps * 32 * (BN + 1));
  s.part = (size_t)m.take<double>((size_t)BN * d);
  s.bytes = m.p;
  return s;
}

// Chunk buffers of a block part of at most rmax rows in chunks of jc.
__host__ __device__ __forceinline__ int grad_buffers(int rmax, int jc) { return rmax > jc ? 2 : 1; }

template <int BN>
__global__ void __launch_bounds__(kThreads)
grad_cluster_kernel(const float* __restrict__ c, const float* __restrict__ x,
                    const float* __restrict__ alpha, float* __restrict__ out, int n, int cap,
                    int d, int jc, float inv_two_l2, float inv_l2) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cl = blockIdx.y, row0 = (blockIdx.x / cs) * BN;
  const int t0 = split_at(cap, cs, rank), rows = split_at(cap, cs, rank + 1) - t0;
  const int nbuf = grad_buffers((cap + cs - 1) / cs, jc), nch = (rows + jc - 1) / jc;
  const int ldx = rows_ld(d);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GradClusterSmem at = grad_cluster_smem<BN>(d, jc, nbuf);
  float* sx = reinterpret_cast<float*>(smem_raw + at.sx);
  double* sc = reinterpret_cast<double*>(smem_raw + at.sc);
  double* sn1 = reinterpret_cast<double*>(smem_raw + at.sn1);
  double* sw = reinterpret_cast<double*>(smem_raw + at.sw);
  double* dots = reinterpret_cast<double*>(smem_raw + at.dots);
  double* part = reinterpret_cast<double*>(smem_raw + at.part);

  const float* xb = x + ((size_t)cl * cap + t0) * d;
  const float* ab = alpha + (size_t)cl * cap + t0;
  auto stage = [&](int ch) {
    const int r0 = ch * jc;
    stage_tile(sx + (size_t)(ch % nbuf) * jc * ldx, ldx, xb + (size_t)r0 * d, min(jc, rows - r0),
               d, d);
  };
  // cp.async groups: chunk 0, then chunk 1 (empty when there is none)
  stage(0);
  cp_async_commit();
  if (nch > 1) stage(1);
  cp_async_commit();
  load_cands_t<BN, double>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<1>();  // chunk ch has landed
    __syncthreads();     // ... for every thread
    const int r0 = ch * jc, rn = min(jc, rows - r0);
    const float* sxc = sx + (size_t)(ch % nbuf) * jc * ldx;
    rows_dot<BN, double>(sc, sxc, ldx, d, rn, dots, [&](int i, int r, double cr, double n2) {
      sw[r * BN + i] =
          exp(-fmax(sn1[i] + n2 - 2.0 * cr, 0.0) * (double)inv_two_l2) * (double)ab[r0 + r];
    });
    for (int k = threadIdx.x; k < d; k += blockDim.x) {
      double acc[BN], ck[BN];
#pragma unroll
      for (int i = 0; i < BN; ++i) {
        acc[i] = ch == 0 ? 0.0 : part[(size_t)i * d + k];
        ck[i] = sc[k * BN + i];
      }
      for (int r = 0; r < rn; ++r) {
        const double xv = (double)sxc[(size_t)r * ldx + k];
#pragma unroll
        for (int i = 0; i < BN; ++i) acc[i] = fma(sw[r * BN + i], xv - ck[i], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < BN; ++i) part[(size_t)i * d + k] = acc[i];
    }
    __syncthreads();  // the chunk's buffer and w are free again
    if (ch + 2 < nch) stage(ch + 2);
    cp_async_commit();
  }
  cluster.sync();  // every rank's partials are written
  const int k0 = split_at(d, cs, rank), kn = split_at(d, cs, rank + 1) - k0;
  for (int e = threadIdx.x; e < BN * kn; e += blockDim.x) {
    const int i = e / kn, k = k0 + (e - i * kn);
    const size_t ik = (size_t)i * d + k;
    double s = 0.0;  // rank order; the loads of four ranks in flight at once
    for (int q0 = 0; q0 < cs; q0 += 4) {
      double v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = q0 + u < cs ? cluster.map_shared_rank(part, q0 + u)[ik] : 0.0;
#pragma unroll
      for (int u = 0; u < 4; ++u) s += v[u];
    }
    out[((size_t)cl * n + row0 + i) * d + k] = (float)(s * (double)inv_l2);
  }
  cluster.sync();  // the other ranks have read this block's partials
}

template <int BN>
int launch_grad(const float* c, const float* x, const float* alpha, float* out, int nb, int n,
                int cap, int d, int cs, int jc, float inv_two_l2, float inv_l2,
                cudaStream_t stream) {
  if (cs < 1 || cs > cap || jc < 1 || nb < 1 || n % BN) return (int)cudaErrorInvalidValue;
  const int nbuf = grad_buffers((cap + cs - 1) / cs, jc);
  dim3 grid(cs * (n / BN), nb);
  return launch_cluster(grad_cluster_kernel<BN>, grid, cs, grad_cluster_smem<BN>(d, jc, nbuf).bytes,
                        stream, c, x, alpha, out, n, cap, d, jc, inv_two_l2, inv_l2);
}

// The resident routes: each block's whole part in one chunk.
template <int BN>
int launch_grad_resident(const float* c, const float* x, const float* alpha, float* out, int nb,
                         int n, int cap, int d, int cs, float inv_two_l2, float inv_l2,
                         cudaStream_t stream) {
  if (cs < 1) return (int)cudaErrorInvalidValue;
  return launch_grad<BN>(c, x, alpha, out, nb, n, cap, d, cs, (cap + cs - 1) / cs, inv_two_l2,
                         inv_l2, stream);
}
}  // namespace fz

// C interface (bound with ctypes by kernels/loader.py).  Shapes: c (nb, n, d),
// x (nb, cap, d), alpha (nb, cap), out (nb, n, d); n % bn == 0, any cap.
// Every entry takes the cluster size cs (1 <= cs <= min(cap, 16)); the
// tiled ones also the chunk rows jc.  Returns the cudaError_t of the launch.
extern "C" int fz_grad_resident(const float* c, const float* x, const float* alpha, float* out,
                                int nb, int n, int cap, int d, int bn, int cs, float inv_two_l2,
                                float inv_l2, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_grad_resident, c, x, alpha, out, nb, n, cap, d, cs, inv_two_l2,
                 inv_l2, (cudaStream_t)stream)
}

extern "C" int fz_grad_tiled(const float* c, const float* x, const float* alpha, float* out,
                             int nb, int n, int cap, int d, int bn, int cs, int jc,
                             float inv_two_l2, float inv_l2, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_grad, c, x, alpha, out, nb, n, cap, d, cs, jc, inv_two_l2, inv_l2,
                 (cudaStream_t)stream)
}

// Single-client entries: the same kernel launched with one client.
// Shapes: c (n, d), x (cap, d), alpha (cap), out (n, d).
extern "C" int fz_grad_single_resident(const float* c, const float* x, const float* alpha,
                                       float* out, int n, int cap, int d, int bn, int cs,
                                       float inv_two_l2, float inv_l2, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_grad_resident, c, x, alpha, out, 1, n, cap, d, cs, inv_two_l2,
                 inv_l2, (cudaStream_t)stream)
}

extern "C" int fz_grad_single_tiled(const float* c, const float* x, const float* alpha,
                                    float* out, int n, int cap, int d, int bn, int cs, int jc,
                                    float inv_two_l2, float inv_l2, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_grad, c, x, alpha, out, 1, n, cap, d, cs, jc, inv_two_l2, inv_l2,
                 (cudaStream_t)stream)
}
