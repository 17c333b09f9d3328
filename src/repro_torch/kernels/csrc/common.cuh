// Shared device helpers of the GP kernels (gp_score.cu, gp_grad.cu) and the
// projection kernels (proj.cuh).
//
// The GP kernels' resident and gradient routes are thread block clusters,
// one per (client, candidate tile): the scoring's score_cluster_kernel
// (client-batched and single-client) and the gradient mean's
// grad_cluster_kernel (all four entries).  Each block of the cluster owns
// one part of the trajectory (split_at); the parts are exchanged through
// distributed shared memory and the per-block partial sums are reduced in
// rank order, with f64 accumulators and no atomics.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <unordered_map>

namespace fz {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Dynamic shared memory above this needs an explicit opt-in per kernel.
constexpr size_t kDefaultSmem = 48 * 1024;

// ---- helpers of the cluster kernels -------------------------------------

//: Most blocks in one cluster: the portable cluster size on Hopper
//: (kernels/autotune.py CLUSTER), and the largest that Hopper takes once a
//: kernel allows non-portable sizes (kernels/autotune.py SINGLE_CLUSTER).
constexpr int kMaxCluster = 8;
constexpr int kMaxClusterNonPortable = 16;

// Start of part r when `total` items are split into `parts` near-equal
// parts: part r is [split_at(total, parts, r), split_at(total, parts, r + 1)).
// kernels/autotune.py `split` computes the same bounds.
__host__ __device__ __forceinline__ int split_at(int total, int parts, int r) {
  return (int)(((long long)total * r) / parts);
}

__device__ __forceinline__ float fma_t(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Carves 16-byte aligned regions out of dynamic shared memory, in order.
// Started at 0 on the host, the same sequence of take() calls leaves the
// launch's byte count in p, so a kernel and its launcher share one layout.
struct SmemCarve {
  uintptr_t p;
  template <typename T>
  __host__ __device__ T* take(size_t count) {
    T* r = reinterpret_cast<T*>(p);
    p += (count * sizeof(T) + 15) & ~size_t(15);
    return r;
  }
};

__device__ __forceinline__ void cp_async_4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Split cluster barrier: every block arrives early (relaxed) and waits
// before its first access to another block's shared memory, which is then
// known to have started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Start (without committing) the asynchronous copy of a rows x cols tile of
// a row-major global array (leading dimension ldg) into shared rows of
// leading dimension ldd: 16-byte copies where every address allows them,
// 4-byte copies otherwise.
__device__ inline void stage_tile(float* dst, int ldd, const float* __restrict__ src, int rows,
                                  int cols, int ldg) {
  const bool vec = (((uintptr_t)src | (uintptr_t)dst) & 15) == 0 &&
                   ((cols | ldg | ldd) & 3) == 0;
  if (vec) {
    const int c4 = cols >> 2;
    for (int e = threadIdx.x; e < rows * c4; e += blockDim.x) {
      const int r = e / c4, q = e - r * c4;
      cp_async_16(dst + (size_t)r * ldd + 4 * q, src + (size_t)r * ldg + 4 * q);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, q = e - r * cols;
      cp_async_4(dst + (size_t)r * ldd + q, src + (size_t)r * ldg + q);
    }
  }
}

// Leading dimension of trajectory rows staged for rows_dot, where the lanes
// of a warp read one row each: for d % 4 == 0 an odd number of float4s (the
// rows stay 16-byte aligned for cp.async and the lanes' float4 reads hit
// distinct banks), else odd (4-byte copies, distinct banks).
__host__ __device__ __forceinline__ int rows_ld(int d) {
  return d % 4 == 0 ? 4 * ((d / 4) | 1) : (d | 1);
}

// The block's BN candidate rows (BN x d, global f32) into sc in T, laid out
// [k][BN] so that one k's BN values are adjacent, and their squared norms
// into sn1.  Ends synchronised.
template <int BN, typename T>
__device__ void load_cands_t(const float* __restrict__ c, int d, T* sc, T* sn1) {
  for (int e = threadIdx.x; e < BN * d; e += blockDim.x) {
    const int i = e / d, k = e - i * d;
    sc[k * BN + i] = (T)c[e];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < BN; i += kWarps) {
    T s = 0;
    for (int k = lane; k < d; k += 32) {
      const T v = (T)c[i * d + k];
      s = fma_t(v, v, s);
    }
    s = warp_sum(s);
    if (lane == 0) sn1[i] = s;
  }
  __syncthreads();
}

// One column k of rows_dot: x_r[k] into the BN dot products and the norm.
template <int BN, typename T>
__device__ __forceinline__ void dot_step(const T* sc, int k, float x, T (&dot)[BN], T& n2) {
  const T xv = (T)x;
  n2 = fma_t(xv, xv, n2);
#pragma unroll
  for (int i = 0; i < BN; ++i) dot[i] = fma_t(sc[k * BN + i], xv, dot[i]);
}

// Dot products c_i.x_r of the BN candidates (sc, [k][BN]) with `rows`
// trajectory rows (sx, f32, leading dimension ldx = rows_ld(d)) and the
// rows' squared norms, accumulated in T: the warps split d into kWarps
// contiguous segments (of float4s where ldx allows), the lanes take one
// row each (32 rows per pass), and the segments' partials (in part:
// kWarps x 32 x (BN + 1) T) are summed in warp order.  emit(i, r, cross,
// |x_r|^2) is called once for each (i, r), by one thread.  Ends
// synchronised.
template <int BN, typename T, typename Emit>
__device__ void rows_dot(const T* sc, const float* sx, int ldx, int d, int rows, T* part,
                         Emit emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool quads = ldx % 4 == 0;
  const int units = quads ? d / 4 : d;
  const int u0 = split_at(units, kWarps, warp), u1 = split_at(units, kWarps, warp + 1);
  for (int r0 = 0; r0 < rows; r0 += 32) {
    T dot[BN], n2 = 0;
#pragma unroll
    for (int i = 0; i < BN; ++i) dot[i] = 0;
    if (r0 + lane < rows) {
      const float* xr = sx + (size_t)(r0 + lane) * ldx;
      if (quads) {
        for (int u = u0; u < u1; ++u) {
          const float4 x4 = reinterpret_cast<const float4*>(xr)[u];
          dot_step<BN, T>(sc, 4 * u, x4.x, dot, n2);
          dot_step<BN, T>(sc, 4 * u + 1, x4.y, dot, n2);
          dot_step<BN, T>(sc, 4 * u + 2, x4.z, dot, n2);
          dot_step<BN, T>(sc, 4 * u + 3, x4.w, dot, n2);
        }
      } else {
        for (int u = u0; u < u1; ++u) dot_step<BN, T>(sc, u, xr[u], dot, n2);
      }
    }
    T* pw = part + ((size_t)warp * 32 + lane) * (BN + 1);
#pragma unroll
    for (int i = 0; i < BN; ++i) pw[i] = dot[i];
    pw[BN] = n2;
    __syncthreads();
    for (int e = threadIdx.x; e < 32 * BN; e += blockDim.x) {
      const int rl = e / BN, i = e - rl * BN;
      if (r0 + rl >= rows) continue;
      T cr = 0, nn = 0;
      for (int w = 0; w < kWarps; ++w) {
        const T* q = part + ((size_t)w * 32 + rl) * (BN + 1);
        cr += q[i];
        nn += q[BN];
      }
      emit(i, r0 + rl, cr, nn);
    }
    __syncthreads();
  }
}

// Opts `kernel` in to `smem` bytes of dynamic shared memory and, with
// `non_portable`, to clusters of more than kMaxCluster blocks, the first
// time a launch needs more than the kernel holds.  What each kernel holds
// is remembered, so later launches make no attribute call (and a CUDA graph
// captured after a first launch records none).  Returns the cudaError_t of
// a refused opt-in.
inline int grant(const void* kernel, size_t smem, bool non_portable) {
  struct Held {
    size_t smem = kDefaultSmem;
    bool non_portable = false;
  };
  static std::mutex mu;
  static std::unordered_map<const void*, Held> held;
  std::lock_guard<std::mutex> lock(mu);
  Held& h = held[kernel];
  if (non_portable && !h.non_portable) {
    if (cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
      return (int)e;
    h.non_portable = true;
  }
  if (smem > h.smem) {
    if (cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return (int)e;
    h.smem = smem;
  }
  return 0;
}

// Launch `kernel` on clusters of cs blocks along x, with `smem` bytes of
// dynamic shared memory (opted in above the default, by `grant`); clusters
// of more than kMaxCluster blocks are allowed as non-portable sizes.
// Returns the cudaError_t of the launch, including a refused cluster size
// or smem.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, int cs, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (cs < 1 || cs > kMaxClusterNonPortable || grid.x % cs) return (int)cudaErrorInvalidValue;
  if (int e = grant((const void*)kernel, smem, cs > kMaxCluster)) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...)) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace fz

// Block sizes the wrappers may ask for (kernels/autotune.py keeps the same list).
#define FZ_DISPATCH_BN(bn, FN, ...)            \
  switch (bn) {                                \
    case 1: return FN<1>(__VA_ARGS__);         \
    case 2: return FN<2>(__VA_ARGS__);         \
    case 4: return FN<4>(__VA_ARGS__);         \
    case 8: return FN<8>(__VA_ARGS__);         \
    case 16: return FN<16>(__VA_ARGS__);       \
    default: return (int)cudaErrorInvalidValue; \
  }
