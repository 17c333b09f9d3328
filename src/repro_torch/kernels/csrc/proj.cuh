// Shared projection body of the RFF features (rff_features.cu), the RFF
// gradient contraction (rff_grad.cu) and the SE Gram (sqexp.cu), for
// `batch` independent problems laid out back to back:
//
//   acc[i][j] = sum_k a[i][k] * bm[j][k]      a (rows, d), bm (cols, d), row-major
//   out[i][j] = epi(acc[i][j], i, j, |a_i|^2, |bm_j|^2)
//
// Two kernels compute it: a tile kernel (64 x 64 outputs a block) for many
// rows, and a rows kernel (all rows a block, one column a warp) for the
// few rows of an append event's Gram rows.  The rows kernel's dot product,
// lane_dot2 (lane k sums k, k + 32, ... in order, then the butterfly
// warp_sum_f2), is also the projection of the RFF gradient's kernel.
//
// Every sum is carried as an unevaluated pair hi + lo of f32 (compensated
// dot product, Ogita-Rump-Oishi Dot2): each product a*b is split exactly
// into p + pe by one FMA, p is added to hi by TwoSum, and both rounding
// errors go to lo.  The pair holds the sum to about twice f32's precision,
// so the epilogues see the projection and, for the SE Gram, the two row
// norms and the cross product as if computed exactly, and round once.
// That matters on this path: the SE Gram's expanded distance
// |x1|^2 + |x2|^2 - 2 x1.x2 cancels for nearby points (the append events
// compare new rows with a ring of rows a few 1e-2 apart), and its rows
// feed a Gram of condition 1e5, where an f32 rounding of the three terms
// moves the solves; the RFF projections reach |X V^T + b| of tens, where
// one rounding is a few 1e-7 of phase.  All arithmetic is f32 (no tensor
// cores, no TF32): the error-free steps use the _rn intrinsics, which the
// compiler never contracts into an FMA.
//
// Every output is written once by one thread: no atomics, the same bits on
// every run.  Ragged rows, cols and d are masked here (zero-filled
// shared-memory slots add exactly zero), so callers never pad.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace fz {

// An unevaluated sum hi + lo, |lo| <= ulp(hi) / 2 after normalisation.
struct F2 {
  float hi, lo;
};

// s + e == a + b exactly (Knuth's TwoSum).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float z = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, z)), __fsub_rn(b, z));
}

// acc += a * b, compensated: the product's and the sum's rounding errors
// go to acc.lo.
__device__ __forceinline__ void dot2_step(float a, float b, F2& acc) {
  const float p = __fmul_rn(a, b);
  const float pe = fmaf(a, b, -p);
  float s, e;
  two_sum(acc.hi, p, s, e);
  acc.hi = s;
  acc.lo = __fadd_rn(acc.lo, __fadd_rn(pe, e));
}

// (hi + lo) + c as a normalised pair.
__device__ __forceinline__ F2 add_f(F2 x, float c) {
  F2 r;
  float e;
  two_sum(x.hi, c, r.hi, e);
  r.lo = __fadd_rn(x.lo, e);
  two_sum(r.hi, r.lo, r.hi, r.lo);
  return r;
}

constexpr int kProjThreads = 256;  // a 16 x 16 thread grid

// Tile kernel.  Block tile (16 RM) x (16 RN), d chunk KC; thread (tx, ty)
// owns rows ty + 16 r and columns tx + 16 c, so a warp reads two a rows
// (broadcast) and sixteen bm rows at a bank-free stride of KC + 1.  The d
// axis is staged through shared memory in chunks of KC; the next chunk's
// loads are issued into registers before the current chunk is multiplied,
// so their latency overlaps the arithmetic.
template <int RM, int RN, int KC, bool kNorms, class Epi>
__global__ void __launch_bounds__(kProjThreads)
proj_kernel(const float* __restrict__ a, const float* __restrict__ bm, float* __restrict__ out,
            int rows, int cols, int d, long long a_stride, long long b_stride,
            long long out_stride, Epi epi) {
  constexpr int TR = 16 * RM, TC = 16 * RN;
  constexpr int LA = TR * KC / kProjThreads, LB = TC * KC / kProjThreads;
  static_assert(LA * kProjThreads == TR * KC && LB * kProjThreads == TC * KC,
                "tiles must split evenly over the threads");
  __shared__ float sa[TR][KC + 1];
  __shared__ float sb[TC][KC + 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * TR, col0 = blockIdx.x * TC;
  a += blockIdx.z * a_stride;
  bm += blockIdx.z * b_stride;
  out += blockIdx.z * out_stride;

  // element e = threadIdx.x + i * kProjThreads of a tile is (e / KC, e % KC)
  float ra[LA], rb[LB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = threadIdx.x + i * kProjThreads, gr = row0 + e / KC, gk = k0 + e % KC;
      ra[i] = (gr < rows && gk < d) ? a[(size_t)gr * d + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = threadIdx.x + i * kProjThreads, gc = col0 + e / KC, gk = k0 + e % KC;
      rb[i] = (gc < cols && gk < d) ? bm[(size_t)gc * d + gk] : 0.f;
    }
  };

  F2 acc[RM][RN], na[RM], nb[RN];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    na[r] = F2{0.f, 0.f};
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = F2{0.f, 0.f};
  }
#pragma unroll
  for (int c = 0; c < RN; ++c) nb[c] = F2{0.f, 0.f};

  fetch(0);
  for (int k0 = 0; k0 < d; k0 += KC) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int e = threadIdx.x + i * kProjThreads;
      sa[e / KC][e % KC] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = threadIdx.x + i * kProjThreads;
      sb[e / KC][e % KC] = rb[i];
    }
    __syncthreads();
    if (k0 + KC < d) fetch(k0 + KC);  // in flight while this chunk is multiplied
    const int kn = min(KC, d - k0);
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      float av[RM], bv[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) av[r] = sa[ty + 16 * r][k];
#pragma unroll
      for (int c = 0; c < RN; ++c) bv[c] = sb[tx + 16 * c][k];
      if (kNorms) {
#pragma unroll
        for (int r = 0; r < RM; ++r) dot2_step(av[r], av[r], na[r]);
#pragma unroll
        for (int c = 0; c < RN; ++c) dot2_step(bv[c], bv[c], nb[c]);
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
#pragma unroll
        for (int c = 0; c < RN; ++c) dot2_step(av[r], bv[c], acc[r][c]);
      }
    }
    __syncthreads();  // the next chunk overwrites sa / sb
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = row0 + ty + 16 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int col = col0 + tx + 16 * c;
      if (col < cols) out[(size_t)row * cols + col] = epi(acc[r][c], row, col, na[r], nb[c]);
    }
  }
}

template <int RM, int RN, int KC, bool kNorms, class Epi>
int launch_proj_tile(const float* a, const float* bm, float* out, int batch, int rows, int cols,
                     int d, Epi epi, cudaStream_t stream) {
  dim3 grid((cols + 16 * RN - 1) / (16 * RN), (rows + 16 * RM - 1) / (16 * RM), batch);
  proj_kernel<RM, RN, KC, kNorms, Epi><<<grid, kProjThreads, 0, stream>>>(
      a, bm, out, rows, cols, d, (long long)rows * d, (long long)cols * d,
      (long long)rows * cols, epi);
  return (int)cudaGetLastError();
}

// Rows kernel.  A few rows (rows <= BN <= 16: the SE Gram's k appended
// rows, a few RFF feature rows) against many columns.  A block owns
// kRowsTile consecutive columns.  It copies the rows and its columns' rows
// of bm into shared memory by cp.async, every copy issued at once, the rows
// first: the rows' norms (SE Gram) are summed while the columns land.
// Then each column is taken by one warp, or for BN >= 2 by two with the
// rows split between them (the second also sums the column's norm): lane k
// sums k, k + 32, ... in order, one compensated pair per row, the butterfly
// warp_sum_f2 adds the lanes' pairs (TwoSum at each level, the same order
// on every run; every lane ends with the same sums), two rows at a time
// (warp_sum2_f2), and the lane holding a row's sum applies its epilogue.
// BN is the row count itself up to 8, so no chain is summed for a row that
// is not there.
constexpr int kRowsTile = 8;  // columns of a block

// Warps of a column and threads of a block of the rows kernel.
template <int BN>
struct RowsShape {
  static constexpr int kColWarps = BN > 1 ? 2 : 1;
  static constexpr int kThreads = 32 * kRowsTile * kColWarps;
};

__device__ __forceinline__ F2 warp_sum_f2(F2 x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float h = __shfl_xor_sync(0xffffffffu, x.hi, o);
    const float l = __shfl_xor_sync(0xffffffffu, x.lo, o);
    float s, e;
    two_sum(x.hi, h, s, e);
    x.hi = s;
    x.lo = __fadd_rn(__fadd_rn(x.lo, l), e);
  }
  return x;
}

// The butterfly of two sums at once: lanes 0-15 end with warp_sum_f2(a),
// lanes 16-31 with warp_sum_f2(b), bit for bit.  At the first level each
// lane keeps the value of its half and sends the partner the other, so the
// pair costs one butterfly's shuffles and TwoSums, not two; the levels
// below stay within a half.
__device__ __forceinline__ F2 warp_sum2_f2(F2 a, F2 b, int lane) {
  const bool upper = lane & 16;
  F2 x = upper ? b : a;
  const F2 give = upper ? a : b;
  const float h = __shfl_xor_sync(0xffffffffu, give.hi, 16);
  const float l = __shfl_xor_sync(0xffffffffu, give.lo, 16);
  float s, e;
  two_sum(x.hi, h, s, e);
  x.hi = s;
  x.lo = __fadd_rn(__fadd_rn(x.lo, l), e);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    const float h2 = __shfl_xor_sync(0xffffffffu, x.hi, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, x.lo, o);
    two_sum(x.hi, h2, s, e);
    x.hi = s;
    x.lo = __fadd_rn(__fadd_rn(x.lo, l2), e);
  }
  return x;
}

// The sums of N lane-partial pairs, two at a time: value 2p in lane p and
// value 2p + 1 in lane 16 + p (warp_sum2_f2), an odd last value in lane
// N / 2 (warp_sum_f2); lane k receives value pair_index(k) where it exists.
__device__ __forceinline__ int pair_index(int lane) {
  return lane < 16 ? 2 * lane : 2 * (lane - 16) + 1;
}

template <int N>
__device__ __forceinline__ F2 pair_sums(const F2 (&v)[N], int lane) {
  F2 mine = F2{0.f, 0.f};
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const F2 t = warp_sum2_f2(v[2 * q], v[2 * q + 1], lane);
    if ((lane & 15) == q) mine = t;
  }
  if (N % 2) {
    const F2 t = warp_sum_f2(v[N - 1]);
    if (lane == N / 2) mine = t;
  }
  return mine;
}

// acc[i][j] += a_i . b_j and, with kNormB, nb[j] += b_j . b_j over the
// k = lane, lane + 32, ... < d, in that order, by dot2_step: NA rows of a
// and NB rows of b in shared memory (leading dimensions lda, ldb).  The
// caller adds the lanes' pairs with warp_sum_f2 or pair_sums.
template <int NA, int NB, bool kNormB>
__device__ __forceinline__ void lane_dot2(const float* a, int lda, const float* b, int ldb, int d,
                                          int lane, F2 (&acc)[NA][NB], F2 (&nb)[NB]) {
#pragma unroll 2
  for (int k = lane; k < d; k += 32) {
    float bv[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) bv[j] = b[j * ldb + k];
    if (kNormB) {
#pragma unroll
      for (int j = 0; j < NB; ++j) dot2_step(bv[j], bv[j], nb[j]);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const float av = a[i * lda + k];
#pragma unroll
      for (int j = 0; j < NB; ++j) dot2_step(av, bv[j], acc[i][j]);
    }
  }
}

// Shared memory of the rows kernel: the rows (BN x d, zero past `rows`),
// then the block's columns' rows of bm (kRowsTile x d), 16-byte aligned.
template <int BN>
__host__ __device__ __forceinline__ size_t rows_smem_floats(int d) {
  return (((size_t)BN * d + 3) & ~size_t(3)) + (size_t)kRowsTile * d;
}

// One warp's share of a column: NA rows of sa against the column's row
// sb, and with kNorm the column's norm (in every lane); the rows' sums by
// pair_sums, lane k keeping row pair_index(k)'s.
template <int NA, bool kNorm>
__device__ __forceinline__ void rows_share(const float* sa, const float* sb, int d, int lane,
                                           F2& mine, F2& nb) {
  F2 acc[NA][1], nbs[1] = {F2{0.f, 0.f}}, rows[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i][0] = F2{0.f, 0.f};
  lane_dot2<NA, 1, kNorm>(sa, d, sb, d, d, lane, acc, nbs);
#pragma unroll
  for (int i = 0; i < NA; ++i) rows[i] = acc[i][0];
  mine = pair_sums(rows, lane);
  if (kNorm) nb = warp_sum_f2(nbs[0]);
}

// grid (ceil(cols / kRowsTile), batch)
template <int BN, bool kNorms, class Epi>
__global__ void __launch_bounds__(RowsShape<BN>::kThreads)
proj_rows_kernel(const float* __restrict__ a, const float* __restrict__ bm,
                 float* __restrict__ out, int rows, int cols, int d, Epi epi) {
  constexpr int kWarps = kRowsTile * RowsShape<BN>::kColWarps;
  // rows of a column's first warp; the second has the rest
  constexpr int kFirst = RowsShape<BN>::kColWarps == 1 ? BN : (BN + 1) / 2;
  extern __shared__ __align__(16) float smem[];
  __shared__ F2 sna[BN], snb[kRowsTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kRowsTile, ncol = min(kRowsTile, cols - col0);
  a += (size_t)blockIdx.y * rows * d;
  bm += ((size_t)blockIdx.y * cols + col0) * d;
  out += (size_t)blockIdx.y * rows * cols;
  float* sa = smem;
  float* sb = smem + (((size_t)BN * d + 3) & ~size_t(3));
  stage_tile(sa, rows * d, a, 1, rows * d, rows * d);  // the rows as one run of floats
  cp_async_commit();
  stage_tile(sb, ncol * d, bm, 1, ncol * d, ncol * d);
  cp_async_commit();
  for (int e = rows * d + threadIdx.x; e < BN * d; e += blockDim.x) sa[e] = 0.f;
  if (kNorms) {  // the rows' norms while the columns land
    cp_async_wait<1>();
    __syncthreads();
    for (int i = warp; i < rows; i += kWarps) {
      F2 n = F2{0.f, 0.f};
      for (int k = lane; k < d; k += 32) dot2_step(sa[i * d + k], sa[i * d + k], n);
      n = warp_sum_f2(n);
      if (lane == 0) sna[i] = n;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const int c = warp % kRowsTile, half = warp / kRowsTile;
  F2 mine = F2{0.f, 0.f}, nb = F2{0.f, 0.f};
  if (c < ncol) {
    const float* sbc = sb + (size_t)c * d;
    if constexpr (RowsShape<BN>::kColWarps == 1) {
      rows_share<BN, kNorms>(sa, sbc, d, lane, mine, nb);
    } else {
      if (half == 0) rows_share<kFirst, false>(sa, sbc, d, lane, mine, nb);
      else rows_share<BN - kFirst, kNorms>(sa + (size_t)kFirst * d, sbc, d, lane, mine, nb);
      if (half == 1 && lane == 0) snb[c] = nb;
    }
  }
  if constexpr (RowsShape<BN>::kColWarps > 1) {
    __syncthreads();  // the column's norm, from its second warp
    if (kNorms) nb = snb[c < ncol ? c : 0];
  }
  const int r = pair_index(lane), i = half * kFirst + r;
  if (c < ncol && i < rows && r < (half == 0 ? kFirst : BN - kFirst)) {
    const int col = col0 + c;
    out[(size_t)i * cols + col] = epi(mine, i, col, kNorms ? sna[i] : F2{0.f, 0.f}, nb);
  }
}

template <int BN, bool kNorms, class Epi>
int launch_proj_rows(const float* a, const float* bm, float* out, int batch, int rows, int cols,
                     int d, Epi epi, cudaStream_t stream) {
  const size_t smem = sizeof(float) * rows_smem_floats<BN>(d);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(proj_rows_kernel<BN, kNorms, Epi>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((cols + kRowsTile - 1) / kRowsTile, batch);
  proj_rows_kernel<BN, kNorms, Epi><<<grid, RowsShape<BN>::kThreads, smem, stream>>>(
      a, bm, out, rows, cols, d, epi);
  return (int)cudaGetLastError();
}

// One launch over `batch` independent (rows x cols) problems laid out back
// to back.  Up to 16 rows whose slab and column tile fit a block's shared
// memory take the rows kernel above (BN = rows up to 8, else 16); larger
// row counts take the tile kernel with 64 x 64 tiles and d chunks of 64
// (33 KB of shared memory).
template <bool kNorms, class Epi>
int launch_proj(const float* a, const float* bm, float* out, int batch, int rows, int cols, int d,
                Epi epi, cudaStream_t stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0) return 0;
  const size_t slab = ((size_t)(rows <= 8 ? rows : 16) * d + 3) & ~size_t(3);
  if (rows <= 16 && sizeof(float) * (slab + (size_t)kRowsTile * d) <= 227 * 1024) {
    switch (rows) {
      case 1: return launch_proj_rows<1, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      case 2: return launch_proj_rows<2, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      case 3: return launch_proj_rows<3, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      case 4: return launch_proj_rows<4, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      case 5: return launch_proj_rows<5, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      case 6: return launch_proj_rows<6, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      case 7: return launch_proj_rows<7, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      case 8: return launch_proj_rows<8, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      default: return launch_proj_rows<16, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
    }
  }
  return launch_proj_tile<4, 4, 64, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
}

}  // namespace fz
