// Shared projection body of the RFF features (rff_features.cu), the sine
// stage of the RFF gradient contraction (rff_grad.cu) and the SE Gram
// (sqexp.cu), for `batch` independent problems laid out back to back:
//
//   acc[i][j] = sum_k a[i][k] * bm[j][k]      a (rows, d), bm (cols, d), row-major
//   out[i][j] = epi(acc[i][j], i, j, |a_i|^2, |bm_j|^2)
//
// Two kernels compute it: a tile kernel (64 x 64 outputs a block) for many
// rows, and a rows kernel (all rows a block, one column a warp) for the
// few rows of the RFF gradient and of an append event's Gram rows.
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

// Rows kernel.  A few rows (rows <= BN <= 16: the RFF gradient's n
// iterates, the SE Gram's k appended rows) against many columns: the block
// stages all rows of a (BN x d) in shared memory and gives each warp one
// column; the lanes stride over d (coalesced reads of the column's row of
// bm) and keep one compensated pair per row, then a butterfly of shuffles
// adds the 32 lanes' pairs (TwoSum at each level, the same order on every
// run).
// Work per lane is d / 32 steps, so a d of a few hundred is a few dozen
// instructions deep instead of the tile path's d.
constexpr int kRowsWarps = kProjThreads / 32;

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

// grid (ceil(cols / kRowsWarps), batch); dynamic shared memory: the rows
// (BN x d, zero past `rows`).
template <int BN, bool kNorms, class Epi>
__global__ void __launch_bounds__(kProjThreads)
proj_rows_kernel(const float* __restrict__ a, const float* __restrict__ bm,
                 float* __restrict__ out, int rows, int cols, int d, Epi epi) {
  extern __shared__ float sa[];
  __shared__ F2 sna[BN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a += (size_t)blockIdx.y * rows * d;
  bm += (size_t)blockIdx.y * cols * d;
  out += (size_t)blockIdx.y * rows * cols;
  for (int e = threadIdx.x; e < BN * d; e += kProjThreads)
    sa[e] = e < rows * d ? a[e] : 0.f;
  __syncthreads();
  if (kNorms) {
    for (int i = warp; i < BN; i += kRowsWarps) {
      F2 n = F2{0.f, 0.f};
      for (int k = lane; k < d; k += 32) dot2_step(sa[i * d + k], sa[i * d + k], n);
      n = warp_sum_f2(n);
      if (lane == 0) sna[i] = n;
    }
    __syncthreads();
  }
  const int col = blockIdx.x * kRowsWarps + warp;
  if (col >= cols) return;
  const float* br = bm + (size_t)col * d;
  F2 acc[BN], nb = F2{0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN; ++i) acc[i] = F2{0.f, 0.f};
  for (int k = lane; k < d; k += 32) {
    const float bv = br[k];
    if (kNorms) dot2_step(bv, bv, nb);
#pragma unroll
    for (int i = 0; i < BN; ++i) dot2_step(sa[i * d + k], bv, acc[i]);
  }
  if (kNorms) nb = warp_sum_f2(nb);
#pragma unroll
  for (int i = 0; i < BN; ++i) {
    const F2 t = warp_sum_f2(acc[i]);
    if (lane == 0 && i < rows)
      out[(size_t)i * cols + col] = epi(t, i, col, kNorms ? sna[i] : F2{0.f, 0.f}, nb);
  }
}

template <int BN, bool kNorms, class Epi>
int launch_proj_rows(const float* a, const float* bm, float* out, int batch, int rows, int cols,
                     int d, Epi epi, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BN * d;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(proj_rows_kernel<BN, kNorms, Epi>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((cols + kRowsWarps - 1) / kRowsWarps, batch);
  proj_rows_kernel<BN, kNorms, Epi><<<grid, kProjThreads, smem, stream>>>(a, bm, out, rows,
                                                                          cols, d, epi);
  return (int)cudaGetLastError();
}

// One launch over `batch` independent (rows x cols) problems laid out back
// to back.  Up to 16 rows whose (16 x d) slab fits a block's shared memory
// take the rows kernel above; larger row counts take the tile kernel with
// 64 x 64 tiles and d chunks of 64 (33 KB of shared memory).
template <bool kNorms, class Epi>
int launch_proj(const float* a, const float* bm, float* out, int batch, int rows, int cols, int d,
                Epi epi, cudaStream_t stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0) return 0;
  if (rows <= 16 && sizeof(float) * 16 * (size_t)d <= 227 * 1024) {
    const int bn = rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : rows <= 8 ? 8 : 16;
    switch (bn) {
      case 1: return launch_proj_rows<1, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      case 2: return launch_proj_rows<2, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      case 4: return launch_proj_rows<4, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      case 8: return launch_proj_rows<8, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
      default: return launch_proj_rows<16, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
    }
  }
  return launch_proj_tile<4, 4, 64, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
}

}  // namespace fz
