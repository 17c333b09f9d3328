// Shared projection body of the RFF features (rff_features.cu), the RFF
// gradient contraction (rff_grad.cu) and the SE Gram (sqexp.cu), for
// `batch` independent problems laid out back to back:
//
//   acc[i][j] = sum_k a[i][k] * bm[j][k]      a (rows, d), bm (cols, d), row-major
//   out[i][j] = epi(acc[i][j], i, j, |a_i|^2, |bm_j|^2)
//
// Two kernels compute it: a tile kernel (T x T outputs a block, T = 64 or
// 32) for many rows, and a rows kernel (all rows a block, one column a
// warp) for the few rows of an append event's Gram rows.  The rows
// kernel's dot product, lane_dot2 (lane k sums k, k + 32, ... in order,
// then the butterfly warp_sum_f2), is also the projection of the RFF
// gradient's kernel.
//
// Both hand the epilogues each sum as an unevaluated pair hi + lo of f32,
// so that the epilogues see the projection and, for the SE Gram, the two
// row norms and the cross product as if computed exactly, and round once.
// That matters on this path: the SE Gram's expanded distance
// |x1|^2 + |x2|^2 - 2 x1.x2 cancels for nearby points (the append events
// compare new rows with a ring of rows a few 1e-2 apart), and its rows
// feed a Gram of condition 1e5, where an f32 rounding of the three terms
// moves the solves; the RFF projections reach |X V^T + b| of tens, where
// one rounding is a few 1e-7 of phase.
//
// The rows kernel carries its sums as compensated f32 pairs (Ogita-Rump-
// Oishi Dot2): each product a*b is split exactly into p + pe by one FMA, p
// is added to hi by TwoSum, and both rounding errors go to lo; the
// error-free steps use the _rn intrinsics, which the compiler never
// contracts into an FMA.  Its work is a few rows against many columns,
// bound by the bytes it reads, so the ten f32 instructions of a step cost
// nothing there.
//
// The tile kernel is bound by operations: B6's 960 x 512 x 300 is 295
// MFLOP, 4.40 us at 67 TFLOP/s, and factor_init's (5, 192, 192) Gram at
// d=300 112 MFLOP, 1.67 us, against 3.7 MB and 3.0 MB of traffic.  Dot2
// there cost ten f32 instructions per multiply-add.  It sums in f64 on the
// f64 tensor cores instead (mma.sync m16n8k4 f64, 67 TFLOP/s on an H100
// SXM, the rate of the bound): each f32 input is exact in f64, so is each
// product, and an f64 sum of d such products is closer to the exact sum
// than Dot2's pair.  The f64 sum is split into the pair hi = rn(acc), lo =
// rn(acc - hi) for the epilogue.
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

// An f64 value as a normalised pair: hi = rn(x), lo = rn(x - hi), where
// x - hi is exact.
__device__ __forceinline__ F2 split_f64(double x) {
  const float hi = __double2float_rn(x);
  return F2{hi, __double2float_rn(x - (double)hi)};
}

// c += a b over one k-step of 4: the 16 x 4 a fragment (a0 at row g, a1 at
// row g + 8, column t), the 4 x 8 b fragment (b at row t, column g) and the
// 16 x 8 sums (c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8),
// for lane = 4 g + t (CUTLASS cute/atom/mma_traits_sm90.hpp,
// SM90_16x8x4_F64F64F64F64_TN).
__device__ __forceinline__ void mma_f64(double (&c)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Tile kernel.  A block owns a T x T tile of one problem's outputs; its
// T / 8 warps (2 x T / 16) own (T / 2) x 16 of it each: T / 32 fragments of
// 16 rows by two of 8 columns.  The d axis goes in chunks of kTileK through
// shared memory in three steps that overlap across chunks:
//   1. cp.async copies chunk s + 1 of the tile's T rows of a and T rows of
//      bm (f32) into one of two stages (each thread the same slots of
//      every chunk, its addresses taken once);
//   2. the warps convert chunk s from its stage to f64, once per element,
//      into one of two f64 tiles (lane k takes column k of 16 rows; slots
//      past rows, cols or d are zero), and with kNorms add each element's
//      square to the lane's partial norm of its row (lane k sums k,
//      k + 32, ... in order);
//   3. the warps multiply chunk s - 1's f64 tile on the tensor cores.
// Steps 2 and 3 are interleaved in each warp, two rows converted after
// each k-step of 4 multiplied, so the conversions, the shared-memory
// traffic and the tensor cores overlap.  One barrier a chunk separates the
// chunks: a stage is refilled only after its chunk was converted, an f64
// tile only after its chunk was multiplied.  Every sum walks d in the same
// order, whatever T, so the tile choice changes no bit.  The norms' lane
// partials are then added by the butterfly warp_sum (the same order on
// every run), and each thread applies the epilogue to all its sums before
// it stores any (the sincosf and expf chains overlap; out-of-range ones
// use a clamped index and are not stored).  The row stride kTileLd puts
// the 16 lanes of a fragment's half-warp on 16 distinct 8-byte banks.
constexpr int kTileK = 32;
constexpr int kTileLd = kTileK + 4;
//: The card's SMs (H100 SXM): a problem with fewer than half as many
//: 64 x 64 tiles takes 32 x 32 tiles (kernels/autotune.py proj_tile).
constexpr int kTileSms = 132;

// The warps of a T x T tile, and the shared memory of its block in bytes:
// two f32 stages of 2T rows of kTileK, two f64 tiles of 2T rows of
// kTileLd, the 2T norms (f64); kernels/autotune.py proj_threads and
// proj_smem compute the same.
template <int T>
struct TileShape {
  static constexpr int kWn = T / 16, kWarps = 2 * kWn, kThreads = 32 * kWarps;
  static constexpr int kRowsWarp = 2 * T / kWarps;  // staged rows a warp converts: 16
  static constexpr size_t kStage = sizeof(float) * 2 * T * kTileK;
  static constexpr size_t kTile = sizeof(double) * 2 * T * kTileLd;
  static constexpr size_t kSmem = 2 * kStage + 2 * kTile + sizeof(double) * 2 * T;
};

// grid (ceil(cols / T), ceil(rows / T), batch)
template <int T, bool kNorms, class Epi>
__global__ void __launch_bounds__(TileShape<T>::kThreads)
proj_tile_kernel(const float* __restrict__ a, const float* __restrict__ bm,
                 float* __restrict__ out, int rows, int cols, int d, Epi epi) {
  using S = TileShape<T>;
  constexpr int R = 2 * T, RW = S::kRowsWarp, MI = T / 32, KS = kTileK / 4;
  constexpr int NV = R * kTileK / 4 / S::kThreads;  // 16-byte copies a thread issues a chunk
  static_assert(RW % KS == 0 && kTileK == 32 && NV * S::kThreads == R * kTileK / 4,
                "tile shape: a lane converts one column of a chunk");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);
  double* tile = reinterpret_cast<double*>(smem_raw + 2 * S::kStage);
  double* norms = reinterpret_cast<double*>(smem_raw + 2 * S::kStage + 2 * S::kTile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp / S::kWn, wn = warp % S::kWn;
  const int row0 = blockIdx.y * T, col0 = blockIdx.x * T;
  const int nr = min(T, rows - row0), nc = min(T, cols - col0);
  a += ((size_t)blockIdx.z * rows + row0) * d;
  bm += ((size_t)blockIdx.z * cols + col0) * d;
  out += (size_t)blockIdx.z * rows * cols;
  const int nch = (d + kTileK - 1) / kTileK;
  const bool vec = d % 4 == 0 && (((uintptr_t)a | (uintptr_t)bm) & 15) == 0;

  // 1. this thread's 16-byte slots: staged row r (row r of a, or r - T of
  // bm), columns q to q + 3 of every chunk
  const float* vsrc[NV];
  int vdst[NV], vq[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int e = threadIdx.x + i * S::kThreads, r = e / (kTileK / 4);
    vq[i] = 4 * (e % (kTileK / 4));
    vdst[i] = r * kTileK + vq[i];
    const bool ok = r < T ? r < nr : r - T < nc;
    vsrc[i] = ok ? (r < T ? a + (size_t)r * d : bm + (size_t)(r - T) * d) + vq[i] : nullptr;
  }
  auto issue = [&](int ch) {
    const int k0 = ch * kTileK, kn = min(kTileK, d - k0);
    float* st = stage + (ch & 1) * R * kTileK;
    if (vec) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (vsrc[i] && vq[i] < kn) cp_async_16(st + vdst[i], vsrc[i] + k0);
    } else {  // 4-byte copies
#pragma unroll 4
      for (int i = 0; i < 4 * NV; ++i) {
        const int e = threadIdx.x + i * S::kThreads, r = e / kTileK, q = e % kTileK;
        if (q < kn && (r < T ? r < nr : r - T < nc))
          cp_async_4(st + r * kTileK + q, (r < T ? a + (size_t)r * d : bm + (size_t)(r - T) * d)
                                              + k0 + q);
      }
    }
    cp_async_commit();
  };

  double part[RW], acc[MI][2][4];
#pragma unroll
  for (int i = 0; i < RW; ++i) part[i] = 0.0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][ni][v] = 0.0;

  issue(0);
  for (int s = 0; s <= nch; ++s) {
    cp_async_wait<0>();  // chunk s (this thread's copies)
    __syncthreads();     // chunk s landed; chunk s - 1 converted; chunk s - 2 multiplied
    if (s + 1 < nch) issue(s + 1);
    // 2. chunk s's staged rows warp, warp + kWarps, ... (of a for i < RW / 2,
    // then of bm), and 3. chunk s - 1's k-steps, interleaved
    const bool conv = s < nch, mult = s > 0;
    const int kn = conv ? min(kTileK, d - s * kTileK) : 0;
    const int ks = mult ? (min(kTileK, d - (s - 1) * kTileK) + 3) >> 2 : 0;
    const float* src = stage + (s & 1) * R * kTileK;
    double* dst = tile + (s & 1) * R * kTileLd;
    const double* f = tile + ((s + 1) & 1) * R * kTileLd;
    const double* fa = f + (wm * (T / 2) + g) * kTileLd + t;
    const double* fb = f + (T + wn * 16 + g) * kTileLd + t;
    float xv[RW];
    if (conv) {
#pragma unroll
      for (int i = 0; i < RW; ++i) xv[i] = src[(warp + S::kWarps * i) * kTileK + lane];
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < ks) {
        double av[MI][2], bv[2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          av[mi][0] = fa[(16 * mi) * kTileLd + 4 * kk];
          av[mi][1] = fa[(16 * mi + 8) * kTileLd + 4 * kk];
        }
        bv[0] = fb[4 * kk];
        bv[1] = fb[8 * kTileLd + 4 * kk];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) mma_f64(acc[mi][ni], av[mi][0], av[mi][1], bv[ni]);
      }
      if (conv) {
#pragma unroll
        for (int j = 0; j < RW / KS; ++j) {
          const int i = kk * (RW / KS) + j, r = warp + S::kWarps * i;
          const bool ok = lane < kn && (i < RW / 2 ? r < nr : r - T < nc);
          const double x = ok ? (double)xv[i] : 0.0;
          dst[r * kTileLd + lane] = x;
          if (kNorms) part[i] = fma(x, x, part[i]);
        }
      }
    }
  }

  if (kNorms) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const double n = warp_sum(part[i]);
      if (lane == 0) norms[warp + S::kWarps * i] = n;
    }
    __syncthreads();
  }
  float res[MI][2][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = wm * (T / 2) + 16 * mi + g + 8 * (v >> 1);
        const int c = wn * 16 + 8 * ni + 2 * t + (v & 1);
        const F2 n1 = kNorms ? split_f64(norms[r]) : F2{0.f, 0.f};
        const F2 n2 = kNorms ? split_f64(norms[T + c]) : F2{0.f, 0.f};
        res[mi][ni][v] = epi(split_f64(acc[mi][ni][v]), row0 + min(r, nr - 1),
                             col0 + min(c, nc - 1), n1, n2);
      }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8: columns c, c + 1
        const int r = wm * (T / 2) + 16 * mi + g + 8 * h, c = wn * 16 + 8 * ni + 2 * t;
        if (r >= nr || c >= nc) continue;
        float* o = out + (size_t)(row0 + r) * cols + col0 + c;
        if (c + 1 < nc && cols % 2 == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(res[mi][ni][2 * h], res[mi][ni][2 * h + 1]);
        } else {
          o[0] = res[mi][ni][2 * h];
          if (c + 1 < nc) o[1] = res[mi][ni][2 * h + 1];
        }
      }
}

template <int T, bool kNorms, class Epi>
int launch_proj_tile(const float* a, const float* bm, float* out, int batch, int rows, int cols,
                     int d, Epi epi, cudaStream_t stream) {
  constexpr size_t smem = TileShape<T>::kSmem;
  if (int e = grant((const void*)proj_tile_kernel<T, kNorms, Epi>, smem, false)) return e;
  dim3 grid((cols + T - 1) / T, (rows + T - 1) / T, batch);
  proj_tile_kernel<T, kNorms, Epi><<<grid, TileShape<T>::kThreads, smem, stream>>>(
      a, bm, out, rows, cols, d, epi);
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
  if (int e = grant((const void*)proj_rows_kernel<BN, kNorms, Epi>, smem, false)) return e;
  dim3 grid((cols + kRowsTile - 1) / kRowsTile, batch);
  proj_rows_kernel<BN, kNorms, Epi><<<grid, RowsShape<BN>::kThreads, smem, stream>>>(
      a, bm, out, rows, cols, d, epi);
  return (int)cudaGetLastError();
}

// One launch over `batch` independent (rows x cols) problems laid out back
// to back.  Up to 16 rows whose slab and column tile fit a block's shared
// memory take the rows kernel above (BN = rows up to 8, else 16); larger
// row counts take the tile kernel, with 64 x 64 tiles (105 KB of shared
// memory) where they make at least half as many blocks as the card has
// SMs, else 32 x 32 (52.5 KB).
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
  const long long tiles64 = (long long)batch * ((rows + 63) / 64) * ((cols + 63) / 64);
  if (tiles64 >= kTileSms / 2)
    return launch_proj_tile<64, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
  return launch_proj_tile<32, kNorms>(a, bm, out, batch, rows, cols, d, epi, stream);
}

}  // namespace fz
