// Batch-last Cholesky factor and k-RHS solve, templated on the element
// type: the streaming design, which keeps the triangle in device memory.
//
// Shared by csrc/batchlast.cu (float: chol_bl, solve_bl) and csrc/df64.cu
// (double: df_chol_bl, df_solve_bl).  Each .cu file includes this header
// and instantiates the type it needs; the templates live in an unnamed
// namespace, so every translation unit keeps its own copy.  Since the
// lane-group kernels of batchlast_smem.cuh, which keep each lane's
// triangle in shared memory, became the default route, these kernels run
// only where one lane's triangle does not fit in a block's shared memory
// (m > 340 in float, m > 240 in double); their pivot loop, chol_pivots,
// is also the one the fused kernels of batchlast.cu run.
//
// Layout: batch-LAST, exactly as the reference keeps it.  M and L are
// (m, m, B), dinv is (m, B), R and V are (k, m, B), all C-contiguous, so
// element [i, j, b] sits at (i * m + j) * B + b.  The factor takes the
// (W @ d^T).reshape(m, m, B) tensor that the caller forms with a GEMM,
// without a transpose.
//
// Design.  Every access is coalesced over the lane axis: the 32 threads
// of a warp always serve 32 neighbouring lanes, so they touch 32
// neighbouring values.  No padding of B is needed (the TPU's 128-lane
// blocks were a Pallas constraint): the grid is bounds-checked.
//
// * chol_bl_kernel: one block per 32 lanes, its 8 warps splitting the
//   rows (warp w owns rows i = w mod 8).  Per pivot k every warp reads
//   the pivot, the owners scale column k and park it in shared memory
//   (m x 32 values: 8 KB in float, 16 KB in double at m = 64), one
//   barrier, then each owner applies the trailing update to its own
//   rows, reading column k from shared memory; a second barrier closes
//   the step.  The update touches only the lower triangle, half the
//   bytes of the reference's full-square update.  The pivot loop is one
//   routine, chol_pivots, which the fused kernels of batchlast.cu
//   (fused_factor_bl, facsol_bl) run too.
// * solve_bl_kernel: one thread per (lane, right-hand side), walking the
//   reference's loops for its own instance: the forward pass
//   left-looking (a dot with row L[i, :i]), the backward pass
//   right-looking.  The working vector lives in V itself (L1-cached).
//
// Semantics kept from the reference's _chol_body and _df_chol_kernel:
// the per-lane shift reg[b] is added at each pivot read (= factoring
// M + reg*I), the reciprocal diagonal is written to dinv, and a pivot
// <= 0 (or NaN) writes NaN to that diagonal and to dinv, which poisons
// the rest of the lane; other lanes are unaffected.  Only the lower
// triangle of L is factored: no consumer reads the upper triangle (the
// solve reads L[i, :i] and dinv), and it keeps M's values.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // solve_bl / elementwise block size
constexpr int kCholLanes = 32;      // chol_bl: lanes per block (one warp wide)
constexpr int kCholRowWarps = 8;    // chol_bl: warps per block, splitting the rows

template <typename T>
__device__ __forceinline__ T quiet_nan();

template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}

template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// correctly rounded square roots (no fast-math flags are used)
__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return sqrt(v); }

// The block's lane and row-warp coordinates, shared by the factor kernels.
struct BlockLanes {
  int lane;   // threadIdx.x: the lane within the block's 32
  int w;      // threadIdx.y: the row warp
  int b;      // the instance (global lane)
  bool live;  // b < B: threads past B stay in the loops (they meet every
              // barrier) but touch no device memory
};

__device__ __forceinline__ BlockLanes block_lanes(int B) {
  BlockLanes t;
  t.lane = threadIdx.x;
  t.w = threadIdx.y;
  t.b = blockIdx.x * kCholLanes + t.lane;
  t.live = t.b < B;
  return t;
}

// first row > k owned by warp w (rows are owned by warp i mod kCholRowWarps)
__device__ __forceinline__ int first_owned(int k, int w) {
  constexpr int R = kCholRowWarps;
  return k + 1 + ((w - (k + 1)) % R + R) % R;
}

// A pivot hook that does nothing: the plain factor.
struct NoPivotHook {
  template <typename T>
  __device__ __forceinline__ void pivot(int, T) const {}
  template <typename T>
  __device__ __forceinline__ void update(int, int, const T*) const {}
};

// The pivot loop of the batch-last Cholesky, the counterpart of the
// reference's shared _chol_body: chol_bl, fused_factor_bl and facsol_bl
// all run this one routine over a lower triangle already in L.
//
// Per pivot k every warp reads the pivot, the owners scale column k and
// park it in `col` (shared, m x kCholLanes), one barrier, then each owner
// applies the trailing update to its own rows, reading column k from
// shared memory; a second barrier closes the step.  The hook lets a
// caller ride the same sweep: hook.pivot(k, inv) runs before the first
// barrier (every warp, with the pivot's reciprocal), hook.update(k, first,
// col) after it (column k complete in `col`; `first` = this warp's first
// row below k).
template <typename T, typename Hook>
__device__ __forceinline__ void chol_pivots(T* __restrict__ L, T* __restrict__ dinv,
                                            T* __restrict__ col, T r, const BlockLanes& t,
                                            int m, int B, Hook& hook) {
  constexpr int R = kCholRowWarps;
  const size_t sB = static_cast<size_t>(B);
  const size_t sm = static_cast<size_t>(m);
  const int lane = t.lane;
  const T nan = quiet_nan<T>();
  for (int k = 0; k < m; ++k) {
    const size_t kk = (k * sm + k) * sB + t.b;
    const T akk = t.live ? L[kk] + r : T(1);
    const bool pos = akk > T(0);
    const T sq = root(pos ? akk : T(1));
    const T inv = pos ? T(1) / sq : nan;
    const int first = first_owned(k, t.w);
    // column k below the diagonal: L[i, k] *= 1 / L[k, k]
    for (int i = first; i < m; i += R) {
      T v = T(0);
      if (t.live) {
        v = L[(i * sm + k) * sB + t.b] * inv;
        L[(i * sm + k) * sB + t.b] = v;
      }
      col[i * kCholLanes + lane] = v;
    }
    hook.pivot(k, inv);
    __syncthreads();  // column k is complete and every warp has read the pivot
    if (t.live && t.w == k % R) {
      L[kk] = pos ? sq : nan;
      dinv[k * sB + t.b] = inv;
    }
    hook.update(k, first, static_cast<const T*>(col));
    // trailing update of the owned rows, lower triangle:
    // L[i, j] -= L[i, k] * L[j, k]
    if (t.live) {
      for (int i = first; i < m; i += R) {
        const T lik = col[i * kCholLanes + lane];
        T* Li = L + i * sm * sB + t.b;
#pragma unroll 4
        for (int j = k + 1; j <= i; ++j) Li[j * sB] -= lik * col[j * kCholLanes + lane];
      }
    }
    __syncthreads();  // the next pivot is updated and column k may be overwritten
  }
}

template <typename T>
__global__ void __launch_bounds__(kCholLanes * kCholRowWarps)
chol_bl_kernel(const T* __restrict__ M, const T* __restrict__ reg,
               T* __restrict__ L, T* __restrict__ dinv, int m, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* col = reinterpret_cast<T*>(smem_raw);  // (m, kCholLanes): column k, scaled
  const BlockLanes t = block_lanes(B);
  const size_t sB = static_cast<size_t>(B);
  const size_t sm = static_cast<size_t>(m);

  // L := M (whole square: the upper triangle keeps M's values)
  if (t.live) {
    for (int i = t.w; i < m; i += kCholRowWarps) {
      for (int j = 0; j < m; ++j) L[(i * sm + j) * sB + t.b] = M[(i * sm + j) * sB + t.b];
    }
  }
  __syncthreads();

  NoPivotHook hook;
  chol_pivots(L, dinv, col, t.live ? reg[t.b] : T(0), t, m, B, hook);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
solve_bl_kernel(const T* __restrict__ L, const T* __restrict__ dinv,
                const T* __restrict__ R, T* __restrict__ V, int m, int B,
                int k_rhs) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(k_rhs) * B) return;
  const int rhs = static_cast<int>(t / B);
  const int b = static_cast<int>(t - static_cast<int64_t>(rhs) * B);
  const size_t sB = static_cast<size_t>(B);
  const size_t sm = static_cast<size_t>(m);
  const T* Rr = R + rhs * sm * sB + b;
  T* Vr = V + rhs * sm * sB + b;  // the working vector: w[j] at Vr[j * sB]

  // forward, left-looking: w[i] = (r[i] - L[i, :i] . w[:i]) * dinv[i]
  for (int i = 0; i < m; ++i) {
    const T* Li = L + i * sm * sB + b;
    T acc = T(0);
#pragma unroll 4
    for (int j = 0; j < i; ++j) acc += Li[j * sB] * Vr[j * sB];
    Vr[i * sB] = (Rr[i * sB] - acc) * dinv[i * sB + b];
  }
  // backward, right-looking: v[i] = w[i] * dinv[i]; w[:i] -= L[i, :i] * v[i]
  for (int i = m - 1; i >= 0; --i) {
    const T* Li = L + i * sm * sB + b;
    const T vi = Vr[i * sB] * dinv[i * sB + b];
    Vr[i * sB] = vi;
#pragma unroll 4
    for (int j = 0; j < i; ++j) Vr[j * sB] -= Li[j * sB] * vi;
  }
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// Host-side launches of the two templates on the given stream; each
// returns cudaGetLastError() (0 = launched) and does not synchronise.
template <typename T>
int launch_chol_bl(const void* M, const void* reg, void* L, void* dinv, int m, int B,
                   void* stream) {
  cudaGetLastError();  // clear a stale error so the return names this launch
  const size_t smem = static_cast<size_t>(m) * kCholLanes * sizeof(T);
  const cudaError_t err = allow_smem(chol_bl_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kCholLanes, kCholRowWarps);
  const unsigned int grid = static_cast<unsigned int>((B + kCholLanes - 1) / kCholLanes);
  chol_bl_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(M), static_cast<const T*>(reg), static_cast<T*>(L),
      static_cast<T*>(dinv), m, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve_bl(const void* L, const void* dinv, const void* R, void* V, int m, int B,
                    int k_rhs, void* stream) {
  cudaGetLastError();
  solve_bl_kernel<T><<<blocks_for(static_cast<int64_t>(k_rhs) * B), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(dinv), static_cast<const T*>(R),
      static_cast<T*>(V), m, B, k_rhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
