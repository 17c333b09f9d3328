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
// latency of each step, not the FMA rate.  At cap in the thousands the
// 4 n cap^2 flops of the two products hB and hP take over (f64 here).
// Two routes, chosen by the wrapper (kernels/ops.py, kernels/autotune.py):
//  * resident (score_cluster_kernel): one thread block cluster per
//    (client, tile of BN candidates), each block owning a part of the
//    trajectory, h exchanged through distributed shared memory; the client-
//    batched entry (B1, the main path) takes clusters of up to 8 blocks,
//    the single-client entry (B7a) up to 16 with 4 candidates per tile, so
//    one client's 50 candidates spread over 208 blocks.  Its note is above
//    the kernel.
//  * cap-tiled (score_h_kernel, score_panel_kernel, score_sum_kernel: B2
//    and B7b): an h pass, a product pass over (rows, columns) panels of B
//    and P, and a fixed-order sum, whatever cap.  Its note is above the
//    kernels.
// Both sum over the trajectory in f64 in a fixed order with no atomics, so
// a second launch gives the same bits, and both are more accurate than the
// f32 plain versions: g1 = hP and g2 = hB cancel heavily (B is the inverse
// of a Gram matrix of condition ~1e5).  Padded trajectory slots (zero rows
// and columns of B and P) contribute zero.
#include "common.cuh"

namespace fz {

// ---- resident route: one cluster per (client, candidate tile) -----------
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
// version, while h in f32 costs little (PERF.md, section 6).  The
// geometry (cs, jc, BN) comes from the wrapper (kernels/autotune.py
// cluster_geometry): the client-batched entry gives each block up to 32
// rows with at most 8 blocks, the single-client entry up to 16 blocks of
// about 12 rows; the arithmetic of each output is the same for both.
// Shared memory (score_cluster_smem; kernels/autotune.py mirrors it): h
// (cap x BN, f64), the candidates, |c|^2, c.x of the own rows, the ranks'
// partials (cs x BN, f64), kStages x 2 chunk buffers (jc x rmax, f32) and
// one region used first for the own rows of X (rmax x rows_ld(d), f32) with
// rows_dot's partials, then for the column sums of step 5 (kThreads x 2 BN,
// f64); rmax = ceil(cap / cs).
//: Chunks of B and P in flight in score_cluster_kernel and
//: score_panel_kernel (kernels/autotune.py STAGES).
constexpr int kStages = 4;

template <int BN>
__host__ __device__ size_t score_cluster_union(int d, int rmax) {
  const size_t a = ((4 * (size_t)rmax * rows_ld(d) + 15) & ~size_t(15)) +
                   4 * (size_t)kWarps * 32 * (BN + 1);
  const size_t b = 8 * (size_t)kThreads * 2 * BN;
  return a > b ? a : b;
}

// Byte offsets of the regions above, and `bytes` in all.  Offsets, not
// pointers: a pointer the kernel derives from its shared array keeps the
// shared state space, so its loads are shared-memory loads.
struct ScoreClusterSmem {
  size_t sh, sc, sn1, scr, red, sp, sb, u, bytes;
};

template <int BN>
__host__ __device__ inline ScoreClusterSmem score_cluster_smem(int cap, int d, int cs, int jc) {
  const int rmax = (cap + cs - 1) / cs;
  SmemCarve m{0};
  ScoreClusterSmem s;
  s.sh = (size_t)m.take<double>((size_t)cap * BN);  // h over the whole trajectory ([t][BN])
  s.sc = (size_t)m.take<float>((size_t)d * BN);     // the candidates ([k][BN])
  s.sn1 = (size_t)m.take<float>(BN);                // |c|^2
  s.scr = (size_t)m.take<float>((size_t)rmax * BN);  // c.x of the own rows ([r][BN])
  s.red = (size_t)m.take<double>((size_t)cs * BN);   // the ranks' partials ([rank][BN])
  s.sp = (size_t)m.take<float>(kStages * (size_t)jc * rmax);  // chunks of P[:, R]
  s.sb = (size_t)m.take<float>(kStages * (size_t)jc * rmax);  // chunks of B[:, R]
  s.u = (size_t)m.take<unsigned char>(score_cluster_union<BN>(d, rmax));
  s.bytes = m.p;
  return s;
}

// The N values of one row of f64 (16-byte aligned for even N) into registers.
template <int N>
__device__ __forceinline__ void load_row(const double* src, double (&h)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const double2 v = reinterpret_cast<const double2*>(src)[i / 2];
      h[i] = v.x;
      h[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) h[i] = src[i];
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
  const ScoreClusterSmem at = score_cluster_smem<BN>(cap, d, cs, jc);
  double* sh = reinterpret_cast<double*>(smem_raw + at.sh);
  double* red = reinterpret_cast<double*>(smem_raw + at.red);
  float* sc = reinterpret_cast<float*>(smem_raw + at.sc);
  float* sn1 = reinterpret_cast<float*>(smem_raw + at.sn1);
  float* scr = reinterpret_cast<float*>(smem_raw + at.scr);
  float* sp = reinterpret_cast<float*>(smem_raw + at.sp);
  float* sb = reinterpret_cast<float*>(smem_raw + at.sb);
  float* sx = reinterpret_cast<float*>(smem_raw + at.u);
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
  double* gs = reinterpret_cast<double*>(smem_raw + at.u);  // [seg][g1 | g2][i][kw]
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
int launch_cluster_score(const float* c, const float* x, const float* bm, const float* pm,
                         float* out, int nb, int n, int cap, int d, int cs, int jc,
                         float inv_two_l2, float inv_l4, float prior, cudaStream_t stream) {
  if (cs < 1 || cs > cap || jc < 1 || (cap + cs - 1) / cs > kThreads)
    return (int)cudaErrorInvalidValue;
  dim3 grid(cs * (n / BN), nb);
  return launch_cluster(score_cluster_kernel<BN>, grid, cs,
                        score_cluster_smem<BN>(cap, d, cs, jc).bytes, stream, c, x, bm, pm, out,
                        n, cap, d, jc, inv_two_l2, inv_l4, prior);
}

// ---- cap-tiled route: an h pass, a panel pass and the sums ---------------
//
// For each client, with n candidates (a multiple of BN) and any cap:
//  1. score_h_kernel, grid (ceil(cap / kHRows), n / BN, N): h_t and
//     m_t = 2 c.x_t - |c|^2 of BN candidates at kHRows trajectory rows, all
//     in f64 (one warp per row, lanes along d, a butterfly per sum; the
//     products of two f32 values are exact in f64, and exp is taken in
//     f64), into the work buffer ([t][i]): each (candidate, row) once.
//  2. score_panel_kernel, grid (ceil(cap / 32), ceil(cap / bc), N * groups):
//     a block owns the panel of rows [j0, j0 + bc) and columns
//     [k0, k0 + 32) of B and P, one column per lane, and a group of up to
//     8 * CPW candidates, CPW per warp.  It streams the panel and the rows'
//     h through shared memory by cp.async, kStages chunks of up to
//     kPanelChunk rows ahead, and sums g1 = sum_j h_j P_jk and
//     g2 = sum_j h_j B_jk over the panel's rows in f64; then the panel's
//     part of corr, sum_k (g1 - m_k g2) h_k, over its columns (a butterfly)
//     into the work buffer's partials ([i][cell]).  corr is linear in each
//     (j, k) of B and P, so the panels' parts add up to it.  So B and P are
//     read once per client (once per group of up to 128 candidates), and
//     each row of h once per panel; a pinned bc sets the panel's rows.
//  3. score_sum_kernel, grid (ceil(n / 8), N): one warp per candidate adds
//     its partials (lanes along the cells, then a butterfly: a fixed order)
//     and writes max(prior - corr / l^4, 0).
// Every sum is f64 in a fixed order, with no atomics; nothing depends on
// the client count, so one client's scores are those of its row in a
// client-batched call, bit for bit.  Ragged cap and panels (cap not a
// multiple of bc or of 32) are masked.  Work buffer (f64, allocated by the
// wrapper; kernels/autotune.py score_tiled_work): h and m (N x cap x n
// each), then the partials (N x n x cells, cells = ceil(cap / 32) x
// ceil(cap / bc)).  Shared memory: score_h_kernel the BN x d candidates
// and their norms (f64); score_panel_kernel kStages x (2 x jc x 32 f32 +
// jc x 8 CPW f64), jc = min(kPanelChunk, bc): at most 160 KB (CPW = 16).
//: Trajectory rows of one block of the h pass.
constexpr int kHRows = 16;
//: Columns of B and P of one panel (a warp's lanes), and its rows per chunk.
constexpr int kPanelCols = 32;
constexpr int kPanelChunk = 32;

template <int BN>
__global__ void __launch_bounds__(kThreads)
score_h_kernel(const float* __restrict__ c, const float* __restrict__ x,
               double* __restrict__ hm, int nb, int n, int cap, int d, double inv_two_l2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sc = reinterpret_cast<double*>(smem_raw);  // the candidates ([i][k])
  double* sn1 = sc + (size_t)BN * d;                 // |c|^2
  const int cl = blockIdx.z, i0 = blockIdx.y * BN, t0 = blockIdx.x * kHRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* cb = c + ((size_t)cl * n + i0) * d;
  for (int e = threadIdx.x; e < BN * d; e += blockDim.x) sc[e] = (double)cb[e];
  __syncthreads();
  for (int i = warp; i < BN; i += kWarps) {
    double s = 0.0;
    for (int k = lane; k < d; k += 32) s = fma(sc[i * d + k], sc[i * d + k], s);
    s = warp_sum(s);
    if (lane == 0) sn1[i] = s;
  }
  __syncthreads();  // the candidates and their norms
  double* hb = hm + (size_t)cl * cap * n + i0;
  double* mb = hm + ((size_t)nb + cl) * cap * n + i0;
  const int rows = min(kHRows, cap - t0);
  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = x + ((size_t)cl * cap + t0 + r) * d;
    double dot[BN], n2 = 0.0;
#pragma unroll
    for (int i = 0; i < BN; ++i) dot[i] = 0.0;
    for (int k = lane; k < d; k += 32) {
      const double xv = (double)xr[k];
      n2 = fma(xv, xv, n2);
#pragma unroll
      for (int i = 0; i < BN; ++i) dot[i] = fma(sc[i * d + k], xv, dot[i]);
    }
    n2 = warp_sum(n2);
#pragma unroll
    for (int i = 0; i < BN; ++i) {
      const double cr = warp_sum(dot[i]);
      if (lane == i) {
        const size_t at = (size_t)(t0 + r) * n + i;
        hb[at] = exp(-fmax(sn1[i] + n2 - 2.0 * cr, 0.0) * inv_two_l2);
        mb[at] = 2.0 * cr - sn1[i];
      }
    }
  }
}

template <int CPW>
__global__ void __launch_bounds__(kThreads)
score_panel_kernel(const double* __restrict__ hm, const float* __restrict__ bm,
                   const float* __restrict__ pm, double* __restrict__ part, int nb, int n,
                   int cap, int bc, int groups) {
  constexpr int G = kWarps * CPW;  // candidates of one group
  const int cl = blockIdx.z / groups, grp = blockIdx.z - cl * groups;
  const int k0 = blockIdx.x * kPanelCols, j0 = blockIdx.y * bc;
  const int kn = min(kPanelCols, cap - k0), jn = min(bc, cap - j0);
  const int g0 = grp * G, gn = min(G, n - g0);
  const int jc = min(kPanelChunk, bc), nch = (jn + jc - 1) / jc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ib = warp * CPW;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sp = reinterpret_cast<float*>(smem_raw);  // kStages chunks of P (jc x 32)
  float* sb = sp + kStages * jc * kPanelCols;      // ... and of B
  double* sh = reinterpret_cast<double*>(sb + kStages * jc * kPanelCols);  // of h (jc x G)
  const double* hb = hm + (size_t)cl * cap * n;
  const double* mb = hm + ((size_t)nb + cl) * cap * n;
  const size_t gp = ((size_t)cl * cap + j0) * cap + k0;  // row j0, column k0 of B and P

  if (gn < G) {  // the group's slots past the candidates stay 0 in every buffer
    for (int e = threadIdx.x; e < kStages * jc * G; e += blockDim.x)
      if (e % G >= gn) sh[e] = 0.0;
  }
  auto stage = [&](int ch) {
    const int r0 = ch * jc, rn = min(jc, jn - r0), buf = ch % kStages;
    stage_tile(sp + buf * jc * kPanelCols, kPanelCols, pm + gp + (size_t)r0 * cap, rn, kn, cap);
    stage_tile(sb + buf * jc * kPanelCols, kPanelCols, bm + gp + (size_t)r0 * cap, rn, kn, cap);
    stage_tile(reinterpret_cast<float*>(sh + (size_t)buf * jc * G), 2 * G,
               reinterpret_cast<const float*>(hb + (size_t)(j0 + r0) * n + g0), rn, 2 * gn,
               2 * n);
  };
  for (int ch = 0; ch < kStages; ++ch) {
    if (ch < nch) stage(ch);
    cp_async_commit();
  }
  double g1[CPW], g2[CPW];
#pragma unroll
  for (int q = 0; q < CPW; ++q) g1[q] = g2[q] = 0.0;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<kStages - 1>();  // chunk ch has landed
    __syncthreads();
    const int buf = ch % kStages, rn = min(jc, jn - ch * jc);
    const float* pp = sp + buf * jc * kPanelCols + lane;
    const float* bb = sb + buf * jc * kPanelCols + lane;
    const double* hh = sh + (size_t)buf * jc * G + ib;
    for (int jj = 0; jj < rn; ++jj) {
      const double p = (double)pp[jj * kPanelCols], b = (double)bb[jj * kPanelCols];
      double h[CPW];
      load_row<CPW>(hh + (size_t)jj * G, h);
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        g1[q] = fma(h[q], p, g1[q]);
        g2[q] = fma(h[q], b, g2[q]);
      }
    }
    __syncthreads();  // the buffer is free again
    if (ch + kStages < nch) stage(ch + kStages);
    cp_async_commit();
  }
  // the panel's part of corr_i: its columns' terms, summed over the lanes
  const int cells = gridDim.x * gridDim.y, cell = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t k = (size_t)(k0 + lane) * n;
#pragma unroll
  for (int q = 0; q < CPW; ++q) {
    const int i = g0 + ib + q;
    double t = 0.0;
    if (lane < kn && ib + q < gn) t = (g1[q] - mb[k + i] * g2[q]) * hb[k + i];
    t = warp_sum(t);
    if (lane == 0 && ib + q < gn) part[((size_t)cl * n + i) * cells + cell] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
score_sum_kernel(const double* __restrict__ part, float* __restrict__ out, int n, int cells,
                 double inv_l4, double prior) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = blockIdx.y, i = blockIdx.x * kWarps + warp;
  if (i >= n) return;
  const double* pr = part + ((size_t)cl * n + i) * cells;
  double s = 0.0;
  for (int e = lane; e < cells; e += 32) s += pr[e];
  s = warp_sum(s);
  if (lane == 0) out[(size_t)cl * n + i] = (float)fmax(prior - s * inv_l4, 0.0);
}

// Candidates per warp of the panel pass: the fewest of 1, 2, 4, 8, 16 that
// cover n with 8 warps, 16 past 64 candidates (then groups of 128).
// kernels/autotune.py panel_cpw computes the same.
inline int panel_cpw(int n) {
  int cpw = 1;
  while (cpw < 16 && kWarps * cpw < n) cpw <<= 1;
  return cpw;
}

// Set once per kernel: its launches may use up to a block's whole shared
// memory (227 KB) as dynamic shared memory (the kernel has no static).
template <typename K>
int allow_smem(K kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   227 * 1024);
}

template <int CPW>
int launch_panel(const double* hm, const float* bm, const float* pm, double* part, int nb, int n,
                 int cap, int bc, cudaStream_t stream) {
  static const int attr = allow_smem(score_panel_kernel<CPW>);
  if (attr) return attr;
  const int groups = (n + kWarps * CPW - 1) / (kWarps * CPW), jc = min(kPanelChunk, bc);
  const size_t smem = (size_t)kStages * jc * (2 * 4 * kPanelCols + 8 * kWarps * CPW);
  dim3 grid((cap + kPanelCols - 1) / kPanelCols, (cap + bc - 1) / bc, nb * groups);
  score_panel_kernel<CPW><<<grid, kThreads, smem, stream>>>(hm, bm, pm, part, nb, n, cap, bc,
                                                            groups);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_tiled(const float* c, const float* x, const float* bm, const float* pm, float* out,
                 double* work, int nb, int n, int cap, int d, int bc, double inv_two_l2,
                 double inv_l4, double prior, cudaStream_t stream) {
  if (bc < 1 || n % BN || nb < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  static const int attr = allow_smem(score_h_kernel<BN>);
  if (attr) return attr;
  const size_t hsmem = 8 * ((size_t)BN * d + BN);
  score_h_kernel<BN><<<dim3((cap + kHRows - 1) / kHRows, n / BN, nb), kThreads, hsmem, stream>>>(
      c, x, work, nb, n, cap, d, inv_two_l2);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  double* part = work + 2 * (size_t)nb * cap * n;
  int e;
  switch (panel_cpw(n)) {
    case 1: e = launch_panel<1>(work, bm, pm, part, nb, n, cap, bc, stream); break;
    case 2: e = launch_panel<2>(work, bm, pm, part, nb, n, cap, bc, stream); break;
    case 4: e = launch_panel<4>(work, bm, pm, part, nb, n, cap, bc, stream); break;
    case 8: e = launch_panel<8>(work, bm, pm, part, nb, n, cap, bc, stream); break;
    default: e = launch_panel<16>(work, bm, pm, part, nb, n, cap, bc, stream); break;
  }
  if (e) return e;
  const int cells = ((cap + kPanelCols - 1) / kPanelCols) * ((cap + bc - 1) / bc);
  score_sum_kernel<<<dim3((n + kWarps - 1) / kWarps, nb), kThreads, 0, stream>>>(
      part, out, n, cells, inv_l4, prior);
  return (int)cudaGetLastError();
}
}  // namespace fz

// C interface (bound with ctypes by kernels/loader.py).  Shapes: c (nb, n, d),
// x (nb, cap, d), bm/pm (nb, cap, cap), out (nb, n); n % bn == 0.  The
// resident route takes the cluster geometry (cs blocks, chunks of jc rows);
// the tiled route any cap, a panel of bc rows, and a work buffer of
// kernels/autotune.py score_tiled_work(nb, n, cap, bc) doubles.  Returns the
// cudaError_t of the launch (the first failing one of the tiled route's).
extern "C" int fz_score_resident(const float* c, const float* x, const float* bm,
                                 const float* pm, float* out, int nb, int n, int cap, int d,
                                 int bn, int cs, int jc, float inv_two_l2, float inv_l4,
                                 float prior, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_cluster_score, c, x, bm, pm, out, nb, n, cap, d, cs, jc,
                 inv_two_l2, inv_l4, prior, (cudaStream_t)stream)
}

extern "C" int fz_score_tiled(const float* c, const float* x, const float* bm, const float* pm,
                              float* out, double* work, int nb, int n, int cap, int d, int bn,
                              int bc, double inv_two_l2, double inv_l4, double prior,
                              void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_tiled, c, x, bm, pm, out, work, nb, n, cap, d, bc, inv_two_l2,
                 inv_l4, prior, (cudaStream_t)stream)
}

// Single-client entries: the bodies above launched with one client.
// Shapes: c (n, d), x (cap, d), bm/pm (cap, cap), out (n).  The resident
// one takes clusters of up to 16 blocks (non-portable).
extern "C" int fz_score_single_resident(const float* c, const float* x, const float* bm,
                                        const float* pm, float* out, int n, int cap, int d,
                                        int bn, int cs, int jc, float inv_two_l2, float inv_l4,
                                        float prior, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_cluster_score, c, x, bm, pm, out, 1, n, cap, d, cs, jc,
                 inv_two_l2, inv_l4, prior, (cudaStream_t)stream)
}

extern "C" int fz_score_single_tiled(const float* c, const float* x, const float* bm,
                                     const float* pm, float* out, double* work, int n, int cap,
                                     int d, int bn, int bc, double inv_two_l2, double inv_l4,
                                     double prior, void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_tiled, c, x, bm, pm, out, work, 1, n, cap, d, bc, inv_two_l2,
                 inv_l4, prior, (cudaStream_t)stream)
}

extern "C" const char* fz_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
