// Active-query uncertainty scoring on Hopper, client-batched and single-client.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/gp_score.py  uncertainty_scores_clients_kernel        (resident)
//   repro/kernels/gp_score.py  uncertainty_scores_tiled_clients_kernel  (cap-tiled)
//   repro/kernels/gp_score.py  uncertainty_scores_kernel                (single client)
//   repro/kernels/gp_score.py  uncertainty_scores_tiled_kernel          (single, cap-tiled)
// and computes, per candidate c of client b,
//   score(c) = max(prior - corr(c), 0),
//   corr(c) * l^4 = sum_k [ (hP)_k - (2 c.x_k - |c|^2) (hB)_k ] h_k,
//   h_t = exp(-max(|c|^2 + |x_t|^2 - 2 c.x_t, 0) / 2 l^2),
// with B the masked Gram inverse and P = B o XX^T (both (cap, cap)).
//
// What bounds it on the card: per launch it must read N (2 cap^2 + cap d
// + n d) floats and do about N n (2 cap d + 4 cap^2) flops, so at the main
// path's shapes (N=5, n=50, cap=192, d=300) both bounds are about 1 us: a
// few dozen MFLOP, so what costs is spreading them over the card and the
// latency of each step, not the FMA rate.  Three kernels, routed by the
// wrapper (kernels/ops.py, kernels/autotune.py):
//  * client-batched resident (score_cluster_kernel, the main path): one
//    thread block cluster per (client, tile of BN candidates), each block
//    owning up to 32 trajectory rows, so a client's work spreads over
//    N n / BN clusters of up to 8 SMs (210 blocks at the main path's
//    shapes); h is exchanged through distributed shared memory, B and P
//    stream through shared memory by cp.async, four chunks ahead, and the
//    sums over the trajectory are f64 in a fixed order (no atomics), which
//    also makes the kernel more accurate than its f32 plain version.  Its
//    note is above the kernel.
//  * resident, one block per (client, tile) looping over the whole
//    trajectory (score_resident_kernel: the single-client entries): h and
//    c.x for the whole trajectory (BN x cap each) stay in shared memory; X,
//    B and P stream from global memory, one thread per column k.  One
//    client's n / BN = 7 blocks on 132 SMs: latency bounds it.
//  * cap-tiled (score_tiled_kernel: client-batched and single-client):
//    (j, k) tiles of bc trajectory rows; h_j, h_k and c.x_k are recomputed
//    per cell, so shared memory is O(BN (d + bc)) whatever cap.
// Padded trajectory slots (zero rows/columns of B and P) contribute zero.
#include "common.cuh"

namespace fz {

// Accumulate one (j, k) cell: for every column k of the cell owned by this
// thread, g1 = sum_j h_j P_jk, g2 = sum_j h_j B_jk over the cell's j rows,
// then acc += (g1 - (2 cross_k - |c|^2) g2) h_k.
template <int BN>
__device__ void score_cell(const float* hj, int ldj, int jlen, const float* hk, const float* ck,
                           int ldk, int klen, const float* __restrict__ b_blk,
                           const float* __restrict__ p_blk, int ldg, const float* sn1,
                           float (&acc)[BN]) {
  for (int k = threadIdx.x; k < klen; k += blockDim.x) {
    float g1[BN], g2[BN];
#pragma unroll
    for (int i = 0; i < BN; ++i) g1[i] = g2[i] = 0.f;
    for (int j = 0; j < jlen; ++j) {
      const float p = p_blk[(size_t)j * ldg + k];
      const float b = b_blk[(size_t)j * ldg + k];
#pragma unroll
      for (int i = 0; i < BN; ++i) {
        const float h = hj[i * ldj + j];
        g1[i] += h * p;
        g2[i] += h * b;
      }
    }
#pragma unroll
    for (int i = 0; i < BN; ++i)
      acc[i] += (g1[i] - (2.f * ck[i * ldk + k] - sn1[i]) * g2[i]) * hk[i * ldk + k];
  }
}

template <int BN>
__device__ void score_store(float (&acc)[BN], float* red, float* out, float inv_l4, float prior) {
  float tot[BN];
  block_sum<BN>(acc, red, tot);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < BN; ++i) out[i] = fmaxf(prior - tot[i] * inv_l4, 0.f);
  }
}

// grid (n / BN, N); shared: c tile, |c|^2, h and c.x over the whole cap.
template <int BN>
__global__ void __launch_bounds__(kThreads)
score_resident_kernel(const float* __restrict__ c, const float* __restrict__ x,
                      const float* __restrict__ bm, const float* __restrict__ pm,
                      float* __restrict__ out, int n, int cap, int d, float inv_two_l2,
                      float inv_l4, float prior) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps * BN];
  float* sc = smem;
  float* sn1 = sc + BN * d;
  float* sh = sn1 + BN;
  float* scr = sh + BN * cap;
  const int cl = blockIdx.y, row0 = blockIdx.x * BN;
  const float* xb = x + (size_t)cl * cap * d;
  const size_t g0 = (size_t)cl * cap * cap;

  load_cands<BN>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);
  h_tile<BN>(sc, sn1, xb, d, 0, cap, inv_two_l2, sh, scr, cap);
  __syncthreads();
  float acc[BN];
#pragma unroll
  for (int i = 0; i < BN; ++i) acc[i] = 0.f;
  score_cell<BN>(sh, cap, cap, sh, scr, cap, cap, bm + g0, pm + g0, cap, sn1, acc);
  score_store<BN>(acc, red, out + (size_t)cl * n + row0, inv_l4, prior);
}

// grid (n / BN, N); shared: c tile, |c|^2, and three BN x bc tiles.
template <int BN>
__global__ void __launch_bounds__(kThreads)
score_tiled_kernel(const float* __restrict__ c, const float* __restrict__ x,
                   const float* __restrict__ bm, const float* __restrict__ pm,
                   float* __restrict__ out, int n, int cap, int d, int bc, float inv_two_l2,
                   float inv_l4, float prior) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps * BN];
  float* sc = smem;
  float* sn1 = sc + BN * d;
  float* shj = sn1 + BN;
  float* shk = shj + BN * bc;
  float* sck = shk + BN * bc;
  const int cl = blockIdx.y, row0 = blockIdx.x * BN;
  const float* xb = x + (size_t)cl * cap * d;
  const size_t g0 = (size_t)cl * cap * cap;

  load_cands<BN>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);
  float acc[BN];
#pragma unroll
  for (int i = 0; i < BN; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < cap; j0 += bc) {
    h_tile<BN>(sc, sn1, xb, d, j0, bc, inv_two_l2, shj, nullptr, bc);
    for (int k0 = 0; k0 < cap; k0 += bc) {
      h_tile<BN>(sc, sn1, xb, d, k0, bc, inv_two_l2, shk, sck, bc);
      __syncthreads();
      const size_t off = g0 + (size_t)j0 * cap + k0;
      score_cell<BN>(shj, bc, bc, shk, sck, bc, bc, bm + off, pm + off, cap, sn1, acc);
      __syncthreads();  // the next cell overwrites shk / sck (and shj after the sweep)
    }
  }
  score_store<BN>(acc, red, out + (size_t)cl * n + row0, inv_l4, prior);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int BN>
int launch_resident(const float* c, const float* x, const float* bm, const float* pm,
                    float* out, int nb, int n, int cap, int d, float inv_two_l2, float inv_l4,
                    float prior, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BN * d + BN + 2 * (size_t)BN * cap);
  if (int e = prepare(score_resident_kernel<BN>, smem)) return e;
  dim3 grid(n / BN, nb);
  score_resident_kernel<BN><<<grid, kThreads, smem, stream>>>(c, x, bm, pm, out, n, cap, d,
                                                              inv_two_l2, inv_l4, prior);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_tiled(const float* c, const float* x, const float* bm, const float* pm, float* out,
                 int nb, int n, int cap, int d, int bc, float inv_two_l2, float inv_l4,
                 float prior, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BN * d + BN + 3 * (size_t)BN * bc);
  if (int e = prepare(score_tiled_kernel<BN>, smem)) return e;
  dim3 grid(n / BN, nb);
  score_tiled_kernel<BN><<<grid, kThreads, smem, stream>>>(c, x, bm, pm, out, n, cap, d, bc,
                                                           inv_two_l2, inv_l4, prior);
  return (int)cudaGetLastError();
}


// ---- client-batched resident route: one cluster per (client, tile) ------
//
// score_cluster_kernel: grid (cs * n / BN, N), clusters of cs blocks along x.
// Block `rank` of a cluster owns trajectory rows R = [t0, t0 + cols) =
// split_at(cap, cs, rank) for h and c.x, and the same range as its columns
// k of B and P:
//  1. stage its rows of X (cp.async) and, kStages chunks ahead, chunks of jc
//     rows of its column slices B[:, R] and P[:, R] (the first kStages
//     chunks load under steps 2-4);
//  2. the candidates (f32, [k][BN]) and |c|^2;
//  3. h and c.x for its rows (rows_dot: warps split d, lanes take rows),
//     in f32 as the reference computes them; h is kept in f64;
//  4. push its part of h into every other block's copy (distributed shared
//     memory), then a cluster barrier: every block holds h over the whole
//     trajectory;
//  5. g1 = h P[:, R] and g2 = h B[:, R] over the staged chunks, in f64: lanes
//     take columns, the warps' rows interleave (segments); the segments'
//     sums are added in order through shared memory;
//  6. its partial corr_i = sum_{k in R} [g1 - (2 c.x_k - |c|^2) g2]_k h_k in
//     f64 (fixed order), stored into rank 0's shared memory;
//  7. cluster barrier; rank 0 sums the partials in rank order and writes
//     max(prior - corr / l^4, 0).
// The f64 sums are what make the kernel more accurate than its f32 plain
// version: g1 and g2 cancel heavily (B is the inverse of a Gram matrix of
// condition ~1e5), while h in f32 costs little (PERF.md, section 6).
// Shared memory (ScoreClusterSmem; kernels/autotune.py mirrors it): h
// (cap x BN, f64), the candidates, |c|^2, c.x of the own rows, the ranks'
// partials, kStages x 2 chunk buffers (jc x rmax, f32) and one region used first
// for the own rows of X (rmax x rows_ld(d), f32) with rows_dot's partials, then
// for the column sums of step 5 (kThreads x 2 BN, f64); rmax = ceil(cap / cs).
//: Chunks of B and P in flight in score_cluster_kernel (kernels/autotune.py STAGES).
constexpr int kStages = 4;

template <int BN>
__host__ __device__ size_t score_cluster_union(int d, int rmax) {
  const size_t a = ((4 * (size_t)rmax * rows_ld(d) + 15) & ~size_t(15)) +
                   4 * (size_t)kWarps * 32 * (BN + 1);
  const size_t b = 8 * (size_t)kThreads * 2 * BN;
  return a > b ? a : b;
}

template <int BN>
struct ScoreClusterSmem {
  double* sh;    // h over the whole trajectory ([t][BN])
  float* sc;     // the candidates ([k][BN])
  float* sn1;    // |c|^2
  float* scr;    // c.x of the own rows ([r][BN])
  double* red;   // the ranks' partials; rank 0's is read ([rank][BN])
  float* sp;     // kStages chunk buffers of P[:, R] (jc x rmax each)
  float* sb;     // kStages chunk buffers of B[:, R]
  unsigned char* u;  // X rows + rows_dot partials, then the column sums
  __host__ __device__ ScoreClusterSmem(SmemCarve& m, int cap, int d, int rmax, int jc)
      : sh(m.take<double>((size_t)cap * BN)),
        sc(m.take<float>((size_t)d * BN)),
        sn1(m.take<float>(BN)),
        scr(m.take<float>((size_t)rmax * BN)),
        red(m.take<double>(kMaxCluster * BN)),
        sp(m.take<float>(kStages * (size_t)jc * rmax)),
        sb(m.take<float>(kStages * (size_t)jc * rmax)),
        u(m.take<unsigned char>(score_cluster_union<BN>(d, rmax))) {}
};

// The BN values of one row of h (16-byte aligned for even BN) into registers.
template <int BN>
__device__ __forceinline__ void load_row(const double* src, double (&h)[BN]) {
  if constexpr (BN % 2 == 0) {
#pragma unroll
    for (int i = 0; i < BN; i += 2) {
      const double2 v = reinterpret_cast<const double2*>(src)[i / 2];
      h[i] = v.x;
      h[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BN; ++i) h[i] = src[i];
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
score_cluster_kernel(const float* __restrict__ c, const float* __restrict__ x,
                     const float* __restrict__ bm, const float* __restrict__ pm,
                     float* __restrict__ out, int n, int cap, int d, int jc, float inv_two_l2,
                     float inv_l4, float prior) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cl = blockIdx.y, row0 = (blockIdx.x / cs) * BN;
  const int rmax = (cap + cs - 1) / cs;
  const int t0 = split_at(cap, cs, rank), cols = split_at(cap, cs, rank + 1) - t0;
  const int nch = (cap + jc - 1) / jc, ldx = rows_ld(d);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemCarve m{(uintptr_t)smem_raw};
  const ScoreClusterSmem<BN> sm(m, cap, d, rmax, jc);
  double *sh = sm.sh, *red = sm.red;
  float *sc = sm.sc, *sn1 = sm.sn1, *scr = sm.scr, *sp = sm.sp, *sb = sm.sb;
  float* sx = reinterpret_cast<float*>(sm.u);
  float* part = sx + (((size_t)rmax * ldx + 3) & ~size_t(3));

  const size_t g0 = (size_t)cl * cap * cap + t0;  // column t0 of row 0 of B and P
  auto stage_chunk = [&](int ch) {
    const int j0 = ch * jc, jn = min(jc, cap - j0), buf = (ch % kStages) * jc * rmax;
    stage_tile(sp + buf, cols, pm + g0 + (size_t)j0 * cap, jn, cols, cap);
    stage_tile(sb + buf, cols, bm + g0 + (size_t)j0 * cap, jn, cols, cap);
  };
  // cp.async groups: X rows, then chunks 0 .. kStages - 1 (empty past nch)
  stage_tile(sx, ldx, x + ((size_t)cl * cap + t0) * d, cols, d, d);
  cp_async_commit();
  for (int ch = 0; ch < kStages; ++ch) {
    if (ch < nch) stage_chunk(ch);
    cp_async_commit();
  }

  load_cands_t<BN, float>(c + ((size_t)cl * n + row0) * d, d, sc, sn1);
  cp_async_wait<kStages>();
  __syncthreads();
  rows_dot<BN, float>(sc, sx, ldx, d, cols, part, [&](int i, int r, float cr, float n2) {
    sh[(size_t)(t0 + r) * BN + i] = (double)expf(-fmaxf(sn1[i] + n2 - 2.f * cr, 0.f) * inv_two_l2);
    scr[r * BN + i] = cr;
  });
  cluster_wait();  // every block of the cluster has started
  for (int q = 0; q < cs; ++q) {
    if (q == rank) continue;
    double* rh = cluster.map_shared_rank(sh, q) + (size_t)t0 * BN;
    const double* lh = sh + (size_t)t0 * BN;
    for (int e = threadIdx.x; e < cols * BN; e += blockDim.x) rh[e] = lh[e];
  }
  cluster.sync();  // every block's part of h has arrived everywhere

  // step 5: lanes take columns k (kw of them, a power of 2 >= cols), the
  // nseg = kThreads / kw segments of threads take interleaved rows
  int kw = 32;
  while (kw < cols) kw <<= 1;
  const int nseg = kThreads / kw, k = threadIdx.x % kw, seg = threadIdx.x / kw;
  double g1[BN], g2[BN];
#pragma unroll
  for (int i = 0; i < BN; ++i) g1[i] = g2[i] = 0.0;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<kStages - 1>();  // chunk ch has landed
    __syncthreads();     // ... for every thread
    const int j0 = ch * jc, jn = min(jc, cap - j0);
    const float* pp = sp + (ch % kStages) * jc * rmax;
    const float* bb = sb + (ch % kStages) * jc * rmax;
    if (k < cols) {
      for (int jj = seg; jj < jn; jj += nseg) {
        const double p = (double)pp[jj * cols + k], b = (double)bb[jj * cols + k];
        double h[BN];
        load_row<BN>(sh + (size_t)(j0 + jj) * BN, h);
#pragma unroll
        for (int i = 0; i < BN; ++i) {
          g1[i] = fma(h[i], p, g1[i]);
          g2[i] = fma(h[i], b, g2[i]);
        }
      }
    }
    __syncthreads();  // the buffer is free again
    if (ch + kStages < nch) stage_chunk(ch + kStages);
    cp_async_commit();
  }
  double* gs = reinterpret_cast<double*>(sm.u);  // [seg][g1 | g2][i][kw]
#pragma unroll
  for (int i = 0; i < BN; ++i) {
    gs[((size_t)seg * 2 * BN + i) * kw + k] = g1[i];
    gs[((size_t)seg * 2 * BN + BN + i) * kw + k] = g2[i];
  }
  __syncthreads();
  // step 6: the term of each (i, k), written over its segment-0 g1 slot
  for (int e = threadIdx.x; e < BN * cols; e += blockDim.x) {
    const int i = e / cols, kk = e - i * cols;
    double a1 = 0.0, a2 = 0.0;
    for (int s = 0; s < nseg; ++s) {
      a1 += gs[((size_t)s * 2 * BN + i) * kw + kk];
      a2 += gs[((size_t)s * 2 * BN + BN + i) * kw + kk];
    }
    const double cr = (double)scr[kk * BN + i];
    gs[(size_t)i * kw + kk] = (a1 - (2.0 * cr - (double)sn1[i]) * a2) * sh[(size_t)(t0 + kk) * BN + i];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double* red0 = cluster.map_shared_rank(red, 0);
  for (int i = warp; i < BN; i += kWarps) {
    double s = 0.0;
    for (int kk = lane; kk < cols; kk += 32) s += gs[(size_t)i * kw + kk];
    s = warp_sum(s);
    if (lane == 0) red0[rank * BN + i] = s;
  }
  cluster.sync();  // every rank's partial is in rank 0's red
  if (rank == 0 && (int)threadIdx.x < BN) {
    double tot = 0.0;
    for (int q = 0; q < cs; ++q) tot += red[q * BN + threadIdx.x];
    out[(size_t)cl * n + row0 + threadIdx.x] =
        (float)fmax((double)prior - tot * (double)inv_l4, 0.0);
  }
}

template <int BN>
size_t score_cluster_smem(int cap, int d, int cs, int jc) {
  SmemCarve m{0};
  (void)ScoreClusterSmem<BN>(m, cap, d, (cap + cs - 1) / cs, jc);
  return (size_t)m.p;
}

template <int BN>
int launch_cluster_score(const float* c, const float* x, const float* bm, const float* pm,
                         float* out, int nb, int n, int cap, int d, int cs, int jc,
                         float inv_two_l2, float inv_l4, float prior, cudaStream_t stream) {
  if (cs < 1 || cs > cap || jc < 1 || (cap + cs - 1) / cs > kThreads)
    return (int)cudaErrorInvalidValue;
  dim3 grid(cs * (n / BN), nb);
  return launch_cluster(score_cluster_kernel<BN>, grid, cs,
                        score_cluster_smem<BN>(cap, d, cs, jc), stream, c, x, bm, pm, out, n,
                        cap, d, jc, inv_two_l2, inv_l4, prior);
}
}  // namespace fz

// C interface (bound with ctypes by kernels/loader.py).  Shapes: c (nb, n, d),
// x (nb, cap, d), bm/pm (nb, cap, cap), out (nb, n); n % bn == 0 and, for the
// tiled route, cap % bc == 0.  Returns the cudaError_t of the launch.
extern "C" int fz_score_resident(const float* c, const float* x, const float* bm,
                                 const float* pm, float* out, int nb, int n, int cap, int d,
                                 int bn, int cs, int jc, float inv_two_l2, float inv_l4,
                                 float prior, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_cluster_score, c, x, bm, pm, out, nb, n, cap, d, cs, jc,
                 inv_two_l2, inv_l4, prior, (cudaStream_t)stream)
}

extern "C" int fz_score_tiled(const float* c, const float* x, const float* bm, const float* pm,
                              float* out, int nb, int n, int cap, int d, int bn, int bc,
                              float inv_two_l2, float inv_l4, float prior, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_tiled, c, x, bm, pm, out, nb, n, cap, d, bc, inv_two_l2, inv_l4,
                 prior, (cudaStream_t)stream)
}

// Single-client entries: the client body above launched with one client
// (grid (n / bn, 1)).  Shapes: c (n, d), x (cap, d), bm/pm (cap, cap), out (n).
extern "C" int fz_score_single_resident(const float* c, const float* x, const float* bm,
                                        const float* pm, float* out, int n, int cap, int d,
                                        int bn, float inv_two_l2, float inv_l4, float prior,
                                        void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_resident, c, x, bm, pm, out, 1, n, cap, d, inv_two_l2, inv_l4,
                 prior, (cudaStream_t)stream)
}

extern "C" int fz_score_single_tiled(const float* c, const float* x, const float* bm,
                                     const float* pm, float* out, int n, int cap, int d, int bn,
                                     int bc, float inv_two_l2, float inv_l4, float prior,
                                     void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_tiled, c, x, bm, pm, out, 1, n, cap, d, bc, inv_two_l2, inv_l4,
                 prior, (cudaStream_t)stream)
}

extern "C" const char* fz_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
