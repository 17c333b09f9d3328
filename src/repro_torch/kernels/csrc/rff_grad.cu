// RFF gradient contraction on Hopper (B5), with per-row weights:
//
//   G[i] = grad phi(x_i)^T w_i = -sqrt(2/M) sum_m sin(x_i . v_m + b_m) w_i[m] v_m,
//   x (n, d), v (M, d), b (M,), w_i = ws[i * w_stride ..] -> (n, d).
//
// w_stride = M gives the per-row form of the client-batched engine (row i
// is client i's iterate with its own w); w_stride = 0 gives the
// reference's one-w form.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/rff_grad.py  rff_grad_kernel
// which keeps each (bn, bm) sine tile in VMEM and accumulates the (bn, d)
// output across the sequential M grid axis.  Hopper's blocks run in no
// order, so the sum over M is split into 32 groups of features (group g
// holds the m = g (mod 32)), each summed in order, and the groups are
// added in a fixed order.  One launch: one thread block cluster of
// kGradCluster blocks per row i, each block owning kGradGpb groups.  A block
//
//   1. copies its groups' rows of V, x_i, and b and w_i at its features
//      into shared memory by cp.async, every copy issued at once;
//   2. projects each feature (one warp per kGradFpw features, lane k
//      summing k, k + 32, ... of x_i . v_m by Dot2, then the butterfly
//      warp_sum_f2, two features at a time by warp_sum2_f2), and stores
//      S = sin(x_i . v_m + b_m) w_i[m] in shared memory: the projection
//      comes as a compensated pair hi + lo, the phase is added exactly and
//      sin(hi + lo) taken as sin(hi) + cos(hi) lo;
//   3. sums each group's S[m] v_m over its m in ascending order, one
//      compensated pair per column (thread c owns column c of every group),
//      and stores the pairs into the shared memory of the block whose slice
//      of the d columns holds c (distributed shared memory);
//   4. after a cluster barrier, adds the 32 groups' pairs of each column of
//      its slice in the order g = 0..31: the hi parts by TwoSum (their
//      errors kept), then the lo parts, and scales once.
//
// V is read once per block, from device memory or L2, and S never leaves
// shared memory; no float atomics, the same bits on every run.  Each
// output's arithmetic is that of the earlier two-kernel design (a sine
// stage on proj.cuh's rows kernel, then a reduction kernel), operation for
// operation: the same Dot2 chains, butterflies, epilogue and fixed-order
// group sum, so the outputs keep their bits; only where the operations run
// changed.  With M above what shared memory holds, the features go in
// chunks of `slots` per group, the groups' pairs kept in shared memory
// between chunks (the same order).  The engine takes the difference of
// two such calls (eq. 8, on w_global and on w_local).
//
// What bounds it on the card: bytes, and launch latency in practice.  At
// the main path's n = N = 5, M = 512, d = 300 the call must read V (614 KB),
// 0.19 us at 3.35 TB/s, for 3 MFLOP.  The 5 clusters of 16 blocks read V
// five times, from L2 after the first.  sincosf (not __sincosf): see
// rff_features.cu.
#include <cooperative_groups.h>

#include "proj.cuh"

namespace fz {

namespace cg = cooperative_groups;

struct SinWeightEpilogue {
  const float* b;
  const float* w;
  int w_stride;
  __device__ float operator()(F2 proj, int i, int j, F2, F2) const {
    const F2 t = add_f(proj, b[j]);
    float s, c;
    sincosf(t.hi, &s, &c);
    return fmaf(c, t.lo, s) * w[(size_t)i * w_stride + j];
  }
};

constexpr int kGradGroups = 32;   // groups of features, m = g (mod 32)
constexpr int kGradCluster = 16;  // blocks of a row's cluster (a non-portable size)
constexpr int kGradGpb = kGradGroups / kGradCluster;  // groups a block owns
constexpr int kGradThreads = 512;
constexpr int kGradWarps = kGradThreads / 32;
constexpr int kGradFpw = 2;  // features a warp projects at once
// Shared memory one block may use on Hopper.
constexpr size_t kGradSmemMax = 227 * 1024;

// Shared memory of a block for chunks of `slots` features per group, as
// byte offsets: x_i, a chunk's rows of V (row f = gl * js + j is the j-th
// feature of the block's local group gl in a chunk of js <= slots features
// per group; padded to kGradFpw rows), b, w_i and S at those features, the
// pairs the cluster's blocks send this block for its columns (group q's at
// q * smax + k, k the column within the block's slice, smax =
// ceil(d / kGradCluster)), and where the features go in several chunks,
// the groups' pairs (hi, lo) per column between chunks; `bytes` in all.
// Offsets, not pointers: a pointer the kernel derives from its shared
// array keeps the shared state space, so its loads are shared-memory loads.
struct GradSmem {
  size_t x, v, b, w, s, rhi, rlo, hi, lo, bytes;
};

__host__ __device__ inline GradSmem grad_smem(int d, int slots, bool chunked) {
  const int f = (kGradGpb * slots + kGradFpw - 1) / kGradFpw * kGradFpw;
  const int smax = (d + kGradCluster - 1) / kGradCluster;
  SmemCarve c{0};
  GradSmem s;
  s.x = (size_t)c.take<float>(d);
  s.v = (size_t)c.take<float>((size_t)f * d);
  s.b = (size_t)c.take<float>(f);
  s.w = (size_t)c.take<float>(f);
  s.s = (size_t)c.take<float>(f);
  s.rhi = (size_t)c.take<float>((size_t)kGradGroups * smax);
  s.rlo = (size_t)c.take<float>((size_t)kGradGroups * smax);
  s.hi = (size_t)c.take<float>(chunked ? (size_t)kGradGpb * d : 0);
  s.lo = (size_t)c.take<float>(chunked ? (size_t)kGradGpb * d : 0);
  s.bytes = c.p;
  return s;
}

// Features per group in one chunk: all ceil(M / 32) when they fit shared
// memory, else as many as fit (0: not one fits, d above about 5,000).
// kernels/autotune.py rff_grad_slots computes the same.
inline int grad_slots(int m, int d) {
  const int ns = (m + kGradGroups - 1) / kGradGroups;
  for (int j = ns; j > 0; --j)
    if (grad_smem(d, j, j < ns).bytes <= kGradSmemMax) return j;
  return 0;
}

// The block (rank) whose slice [split_at(d, P, r), split_at(d, P, r + 1))
// holds column c: the last r with split_at(d, P, r) <= c.
__device__ __forceinline__ int slice_owner(int c, int d) {
  return (int)(((long long)kGradCluster * (c + 1) - 1) / d);
}

// grid (kGradCluster, n), clusters of kGradCluster blocks along x.
__global__ void __launch_bounds__(kGradThreads)
rff_grad_kernel(const float* __restrict__ x, const float* __restrict__ v,
                const float* __restrict__ b, const float* __restrict__ w,
                float* __restrict__ out, int m, int d, int w_stride, float neg_scale,
                int slots) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int rank = (int)cluster.block_rank(), row = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = rank * kGradGpb, ns = (m + kGradGroups - 1) / kGradGroups;
  const int smax = (d + kGradCluster - 1) / kGradCluster;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GradSmem at = grad_smem(d, slots, slots < ns);
  float* sx = reinterpret_cast<float*>(smem_raw + at.x);
  float* sv = reinterpret_cast<float*>(smem_raw + at.v);
  float* sb = reinterpret_cast<float*>(smem_raw + at.b);
  float* sw = reinterpret_cast<float*>(smem_raw + at.w);
  float* ss = reinterpret_cast<float*>(smem_raw + at.s);
  float* rhi = reinterpret_cast<float*>(smem_raw + at.rhi);
  float* rlo = reinterpret_cast<float*>(smem_raw + at.rlo);
  float* shi = reinterpret_cast<float*>(smem_raw + at.hi);
  float* slo = reinterpret_cast<float*>(smem_raw + at.lo);
  x += (size_t)row * d;
  w += (size_t)row * w_stride;
  out += (size_t)row * d;
  // b and w_i at the chunk's features, indexed by f
  const SinWeightEpilogue epi{sb, sw, 0};

  for (int j0 = 0; j0 < ns; j0 += slots) {
    const int js = min(slots, ns - j0), nf = kGradGpb * js;
    const bool last = j0 + js == ns;
    // features of each local group in this chunk (not increasing in gl)
    int cnt[kGradGpb];
#pragma unroll
    for (int gl = 0; gl < kGradGpb; ++gl) {
      cnt[gl] = min(js, max(0, (m - (g0 + gl) + kGradGroups - 1) / kGradGroups - j0));
      stage_tile(sv + (size_t)gl * js * d, d, v + (size_t)(g0 + gl + kGradGroups * j0) * d,
                 cnt[gl], d, kGradGroups * d);
    }
    for (int f = threadIdx.x; f < nf; f += kGradThreads) {
      const int gl = f / js, mm = g0 + gl + kGradGroups * (j0 + f - gl * js);
      if (mm < m) {
        cp_async_4(sb + f, b + mm);
        cp_async_4(sw + f, w + mm);
      }
    }
    if (j0 == 0) stage_tile(sx, d, x, 1, d, d);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // 2. S at the chunk's features, kGradFpw features a warp
    for (int f0 = warp * kGradFpw; f0 < nf; f0 += kGradWarps * kGradFpw) {
      F2 acc[1][kGradFpw], unused[kGradFpw];
#pragma unroll
      for (int j = 0; j < kGradFpw; ++j) acc[0][j] = unused[j] = F2{0.f, 0.f};
      lane_dot2<1, kGradFpw, false>(sx, d, sv + (size_t)f0 * d, d, d, lane, acc, unused);
      F2 feats[kGradFpw];
#pragma unroll
      for (int j = 0; j < kGradFpw; ++j) feats[j] = acc[0][j];
      const F2 mine = pair_sums(feats, lane);  // feature f0 + pair_index(lane)'s sum
      const int f = f0 + pair_index(lane), gl = f / js;
      if (pair_index(lane) < kGradFpw && f < nf &&
          g0 + gl + kGradGroups * (j0 + f - gl * js) < m)
        ss[f] = epi(mine, 0, f, F2{0.f, 0.f}, F2{0.f, 0.f});
    }
    __syncthreads();

    // 3. each group's pairs, its features in ascending order; after the
    // last chunk they go to the block that owns the column
    if (last) cluster_wait();  // every block of the cluster has started
    for (int c = threadIdx.x; c < d; c += kGradThreads) {
      F2 acc[kGradGpb];
      const float* vc = sv + c;
#pragma unroll
      for (int gl = 0; gl < kGradGpb; ++gl)
        acc[gl] = j0 == 0 ? F2{0.f, 0.f} : F2{shi[gl * d + c], slo[gl * d + c]};
      // the features every local group has, then the first groups' one more
#pragma unroll 4
      for (int j = 0; j < cnt[kGradGpb - 1]; ++j) {
#pragma unroll
        for (int gl = 0; gl < kGradGpb; ++gl)
          dot2_step(ss[gl * js + j], vc[(size_t)(gl * js + j) * d], acc[gl]);
      }
#pragma unroll
      for (int gl = 0; gl < kGradGpb - 1; ++gl)
        for (int j = cnt[kGradGpb - 1]; j < cnt[gl]; ++j)
          dot2_step(ss[gl * js + j], vc[(size_t)(gl * js + j) * d], acc[gl]);
      if (last) {
        const int r = slice_owner(c, d), k = c - split_at(d, kGradCluster, r);
        float* to_hi = cluster.map_shared_rank(rhi, r);
        float* to_lo = cluster.map_shared_rank(rlo, r);
#pragma unroll
        for (int gl = 0; gl < kGradGpb; ++gl) {
          to_hi[(g0 + gl) * smax + k] = acc[gl].hi;
          to_lo[(g0 + gl) * smax + k] = acc[gl].lo;
        }
      } else {
#pragma unroll
        for (int gl = 0; gl < kGradGpb; ++gl) {
          shi[gl * d + c] = acc[gl].hi;
          slo[gl * d + c] = acc[gl].lo;
        }
      }
    }
    __syncthreads();  // the next chunk overwrites V, b, w and S
  }

  // 4. the groups' pairs in order g = 0..31, over this block's columns
  cluster.sync();  // every block's pairs have arrived
  const int c0 = split_at(d, kGradCluster, rank), nc = split_at(d, kGradCluster, rank + 1) - c0;
  for (int k = threadIdx.x; k < nc; k += kGradThreads) {
    float hi = 0.f, lo = 0.f;
#pragma unroll
    for (int q = 0; q < kGradGroups; ++q) {
      float e;
      two_sum(hi, rhi[q * smax + k], hi, e);
      lo = __fadd_rn(lo, e);
    }
#pragma unroll
    for (int q = 0; q < kGradGroups; ++q) lo = __fadd_rn(lo, rlo[q * smax + k]);
    out[c0 + k] = neg_scale * __fadd_rn(hi, lo);
  }
}

}  // namespace fz

// C interface (bound with ctypes by kernels/loader.py); `scale` is
// sqrt(2/M) of the true M.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue where one feature row per group and the pairs do
// not fit shared memory: d above about 5,000).
extern "C" int fz_rff_grad(const float* x, const float* v, const float* b, const float* w,
                           float* out, int n, int m, int d, int w_stride, float scale,
                           void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const int slots = m > 0 ? fz::grad_slots(m, d) : 0;
  if (slots < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      fz::grad_smem(d, slots, slots < (m + fz::kGradGroups - 1) / fz::kGradGroups).bytes;
  static const cudaError_t attrs = [] {
    cudaError_t e = cudaFuncSetAttribute(fz::rff_grad_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fz::rff_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)fz::kGradSmemMax);
    return e;
  }();
  if (attrs != cudaSuccess) return (int)attrs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(fz::kGradCluster, n, 1);
  cfg.blockDim = dim3(fz::kGradThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = fz::kGradCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaError_t e = cudaLaunchKernelEx(&cfg, fz::rff_grad_kernel, x, v, b, w, out, m, d,
                                         w_stride, -scale, slots))
    return (int)e;
  return (int)cudaGetLastError();
}
