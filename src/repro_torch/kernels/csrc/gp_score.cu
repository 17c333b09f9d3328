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
//   h_t = exp(-|c - x_t|^2 / 2 l^2),
// with B the masked Gram inverse and P = B o XX^T (both (cap, cap)).
//
// What bounds it on the card: per launch it must read N (2 cap^2 + cap d
// + n d) floats and do about N n (2 cap d + 4 cap^2) flops, so at the main
// path's shapes (N=5, n=50, cap=192, d=300) both bounds are about 1 us and
// the launch itself costs more.  The single-client entries (one client,
// n=50) need a fifth of that, about 0.2 us, and get only n / BN = 7 blocks
// on 132 SMs: launch latency and one SM's share of the bandwidth bound
// them.  The design keeps every intermediate on
// chip: one block per (client, tile of BN candidates), the h and c.x
// tiles in shared memory, the B/P sweep as coalesced row reads with the
// per-candidate accumulators in registers.  Each block reads B and P once;
// blocks of one client share them through L2.
//
// Two routes, chosen by the wrapper (kernels/ops.py) as on the TPU:
//  * resident: h and c.x for the whole trajectory (BN x cap each) stay in
//    shared memory; X, B and P stream from global memory.  X itself does
//    not fit (cap d 4 B = 230 KB at the main path's shapes).
//  * tiled: (j, k) tiles of bc trajectory rows; h_j, h_k and c.x_k are
//    recomputed per cell, so shared memory is O(BN (d + bc)) whatever cap.
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

}  // namespace fz

// C interface (bound with ctypes by kernels/loader.py).  Shapes: c (nb, n, d),
// x (nb, cap, d), bm/pm (nb, cap, cap), out (nb, n); n % bn == 0 and, for the
// tiled route, cap % bc == 0.  Returns the cudaError_t of the launch.
extern "C" int fz_score_resident(const float* c, const float* x, const float* bm,
                                 const float* pm, float* out, int nb, int n, int cap, int d,
                                 int bn, float inv_two_l2, float inv_l4, float prior,
                                 void* stream) {
  FZ_DISPATCH_BN(bn, fz::launch_resident, c, x, bm, pm, out, nb, n, cap, d, inv_two_l2, inv_l4,
                 prior, (cudaStream_t)stream)
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
