// Batch-last Cholesky factor and k-RHS solve with each lane's triangle in
// shared memory: the Hopper design of chol_bl / solve_bl (float, in
// batchlast.cu) and df_chol_bl / df_solve_bl (double, in df64.cu).
//
// Replaces, as the default route at every m whose one-lane triangle fits
// in shared memory:
//   chol_bl_smem  <- pycllp_tpu/ops/batchlast.py:223 (_chol_bl)
//                    pycllp_tpu/ops/df64.py:264      (_df_chol_bl)
//   solve_bl_smem <- pycllp_tpu/ops/batchlast.py:273 (_solve_bl)
//                    pycllp_tpu/ops/df64.py:295      (_df_solve_bl)
// The streaming kernels of batchlast.cuh (chol_bl_kernel, solve_bl_kernel)
// stay for the m whose triangle does not fit (m > 340 in float, m > 240 in
// double, at one lane per block), and chol_pivots for the fused kernels of
// batchlast.cu.  The host picks the design by (m, dtype) alone and the
// lane-group size G from (m, dtype, B, SM count); see lane_plan in
// ops/batchlast.py.
//
// What bounds these functions on the H100.  One factor at m = 64 reads M's
// lower triangle and writes L's (8,320 B each per lane in float) and does
// ~87K operations per lane: at B = 16,384 that is 277 MB against 1.4
// GFLOP, so HBM bounds it (0.083 ms at 3.35 TB/s).  The streaming factor
// copied the whole square of M into L and ran every pivot's trailing
// update as a read-modify-write of L in device memory, ~5.7 GB of traffic
// per factor.  One solve reads L's triangle once and R, writes V: 149 MB at
// k = 1, B = 16,384 (0.044 ms); the streaming solve read L twice, from one
// thread per (lane, RHS), which left 128 blocks at B = 16,384 and 8 at the
// drain tier's B = 1,024.  Once the triangle is on chip, what is left is
// the factor's ~m^3/6 trailing updates per lane, which shared memory
// serves (its wavefronts and the instructions around them), and the
// solve's 2m dependent steps per lane (latency).
//
// Both kernels run a block of G warps, one lane (instance) a warp, G = 1,
// 2, 4 or 8 a template parameter.  The block copies its G lanes' lower
// triangles into shared memory once, with cp.async, 4 or 8 bytes an
// element: each entry's G lanes are one contiguous segment of device
// memory, and no register holds the data in flight.  Lanes past B are
// zero-filled, their warps idle, and nothing of theirs is written back.
// The triangles are packed lane-major: lane g's entry (i, j), j <= i, at
// [g * stride + i(i+1)/2 + j], stride = the triangle rounded up to 32
// entries plus 32 / G, so the copy's writes fall in distinct banks.  A row
// of a triangle is contiguous, and a column is conflict-free too:
// i(i+1)/2 runs through every residue mod 32 (and 16) as i runs through 32
// consecutive values.  At m = 64 a lane's triangle is 8,320 B in float
// and 16,640 B in double, so G = 8 (float) or G = 4 (double) is ~67 KB a
// block and three blocks share an SM.  After the copy the warps never meet
// at a block barrier until the factor's write-back: each warp's steps are
// ordered by __syncwarp and shuffles only.
//
// chol_bl_smem: thread t of a warp owns the rows t + 64 q and 63 - t + 64 q
// (q < NP, a template parameter: 1 up to m = 64, 2 up to 128, 6 up to 384),
// so every thread's rows hold the same number of entries.  The pivots run
// in panels of kPanel.  Per pivot k of a panel every thread reads the
// pivot (plus reg) and scales column k on its own rows, keeping L[i, k] in
// a register; one __syncwarp; then it applies pivot k to its rows of the
// panel's later columns, reading L[c, k] as a broadcast; another
// __syncwarp.  After the panel one pass applies its kPanel pivots to every
// trailing entry (i, j), j past the panel: per column j the warp reads the
// kPanel values L[j, p] as broadcasts, and each thread reads its L[i, j]
// once, subtracts the kPanel products in pivot order and writes it once.
// Every L[i, j] receives the same updates in the same pivot order as
// _chol_bl_plain (right-looking), FP32 FMAs in float and FP64 in double
// (no tensor-core path).  L's lower triangle is written once at the end,
// dinv once per pivot.
//
// solve_bl_smem: thread t of a warp owns rows i = t + 32 r (r < R, a
// template parameter: 2 up to m = 64, 4 up to 128, 11 up to 352): their
// right-hand sides and dinv live in registers.  The forward pass is
// column-oriented, riding the pivots as facsol_bl does: the owner of row k
// scales w_k = v_k * dinv[k], a warp shuffle hands w_k to every thread,
// and each applies v_i -= L[i, k] * w_k to its rows i > k.  The backward
// pass is right-looking over rows as in facsol_bl: v_i = w_i * dinv[i]
// from its owner by shuffle, then v_j -= L[i, j] * v_i on the rows j < i.
// A step's critical path is a shuffle and two FMAs; the L reads do not
// depend on it.  More right-hand sides than kSolveRhs run in turns on the
// staged L.
//
// Semantics are those of batchlast.cuh: reg[b] is added at each pivot
// read, a pivot <= 0 or NaN writes NaN to its diagonal and dinv and so
// poisons its own lane only, and only the lower triangle of L and dinv
// carry meaning.  The factor leaves L's upper triangle unwritten (the
// streaming factor kept M's values there): no consumer reads it
// (ops/batchlast.py solve, ops/df64.py solve, ops/mixed.py's f32 factor
// all hand L to the solve, which reads L[i, :i] and dinv).

#pragma once

#include "batchlast.cuh"

namespace {

constexpr int kPanel = 4;     // pivots the factor applies to the trailing entries in one pass
constexpr int kSolveRhs = 2;  // right-hand sides a solve warp holds at once

__host__ __device__ __forceinline__ int tri_row(int i) { return i * (i + 1) / 2; }

// entries between two lanes' triangles in the lane-major layout
__host__ __device__ __forceinline__ int tri_stride(int m, int G) {
  return (tri_row(m) + 31) / 32 * 32 + 32 / G;
}

// cp.async of one element (4 or 8 bytes) from device to shared memory;
// valid == false zero-fills the destination and reads nothing
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool valid) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4 or 8 bytes here");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? static_cast<int>(sizeof(T)) : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(s), "l"(src), "n"(static_cast<int>(sizeof(T))), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the lower triangle of the batch-last (m, m, B) tensor X,
// lanes b0 .. b0 + G - 1, into shared memory: entry (i, j) of lane h goes
// to s[at(tri_row(i) + j, h)].  NT threads share the copy.
template <typename T, int G, int NT, typename At>
__device__ __forceinline__ void stage_tri(T* __restrict__ s, const T* __restrict__ X, int m,
                                          int B, int b0, At at) {
  const size_t sB = static_cast<size_t>(B);
  for (int i = 0; i < m; ++i) {
    const T* xi = X + static_cast<size_t>(i) * m * sB;
    for (int e = threadIdx.x; e < (i + 1) * G; e += NT) {
      const int j = e / G;
      const int h = e % G;
      const bool live = b0 + h < B;
      cp_async_elem(s + at(tri_row(i) + j, h), xi + j * sB + (live ? b0 + h : b0), live);
    }
  }
}

// rows a factor thread owns: pairs (t + 64 q, 63 - t + 64 q), q < NP, so
// the row lengths of every thread add up to the same count
__device__ __forceinline__ int pair_row(int t, int rr) {
  return (rr & 1 ? 63 - t : t) + 64 * (rr >> 1);
}

template <typename T, int G, int NP>
__global__ void __launch_bounds__(32 * G)
chol_bl_smem_kernel(const T* __restrict__ M, const T* __restrict__ reg, T* __restrict__ L,
                    T* __restrict__ dinv, int m, int B) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G is a power of two <= 32");
  constexpr int R = 2 * NP;  // rows a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // G packed triangles, lane-major
  const int stride = tri_stride(m, G);
  const int t = threadIdx.x & 31;
  const int g = threadIdx.x / 32;  // the warp's lane within the group
  const int b0 = blockIdx.x * G;
  const int b = b0 + g;
  const bool live = b < B;
  const size_t sB = static_cast<size_t>(B);

  stage_tri<T, G, 32 * G>(s, M, m, B, b0, [stride](int p, int h) { return h * stride + p; });
  const T r = live ? reg[b] : T(0);
  cp_async_wait_all();
  __syncthreads();  // from here until the write-back each warp is on its own

  if (live) {
    T* sl = s + g * stride;
    const T nan = quiet_nan<T>();
    int row[R];  // the owned rows
    int off[R];  // where they start in the triangle
#pragma unroll
    for (int q = 0; q < R; ++q) {
      row[q] = pair_row(t, q);
      off[q] = tri_row(row[q]);
    }
    for (int k0 = 0; k0 < m; k0 += kPanel) {
      const int k1 = min(k0 + kPanel, m);  // the panel is pivots k0 .. k1 - 1
      T a[R][kPanel];  // L[i, p] of the owned rows i, for the panel's pivots p
#pragma unroll
      for (int p = 0; p < kPanel; ++p) {
        const int k = k0 + p;
        if (k < k1) {
          T* skk = sl + tri_row(k) + k;
          const T akk = *skk + r;
          const bool pos = akk > T(0);
          const T sq = root(pos ? akk : T(1));
          const T inv = pos ? T(1) / sq : nan;
          // column k below the diagonal: L[i, k] *= 1 / L[k, k]
#pragma unroll
          for (int q = 0; q < R; ++q) {
            a[q][p] = T(0);
            if (row[q] > k && row[q] < m) {
              a[q][p] = sl[off[q] + k] * inv;
              sl[off[q] + k] = a[q][p];
            }
          }
          __syncwarp();  // column k is complete and every thread has read the pivot
          if (t == 0) {
            *skk = pos ? sq : nan;
            dinv[k * sB + b] = inv;
          }
          // pivot k on the panel's later columns c: L[i, c] -= L[i, k] * L[c, k]
#pragma unroll
          for (int c = k + 1 - k0; c < kPanel; ++c) {
            if (k0 + c < k1) {
              const T lck = sl[tri_row(k0 + c) + k];
#pragma unroll
              for (int q = 0; q < R; ++q) {
                if (row[q] >= k0 + c && row[q] < m) sl[off[q] + k0 + c] -= a[q][p] * lck;
              }
            }
          }
          __syncwarp();  // the next pivot and its column are up to date
        }
      }
      // the panel's pivots on the trailing entries, in pivot order:
      // L[i, j] -= L[i, p] * L[j, p] for p = k0 .. k1 - 1, k1 <= j <= i
      for (int j = k1; j < m; ++j) {
        const T* lj = sl + tri_row(j) + k0;
        T ljp[kPanel];
#pragma unroll
        for (int p = 0; p < kPanel; ++p) ljp[p] = k0 + p < k1 ? lj[p] : T(0);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (row[q] >= j && row[q] < m) {
            T x = sl[off[q] + j];
#pragma unroll
            for (int p = 0; p < kPanel; ++p) x -= a[q][p] * ljp[p];
            sl[off[q] + j] = x;
          }
        }
      }
      __syncwarp();  // the trailing entries are up to date
    }
  }
  __syncthreads();

  // L's lower triangle, written once
  for (int i = 0; i < m; ++i) {
    T* xi = L + static_cast<size_t>(i) * m * sB;
    for (int e = threadIdx.x; e < (i + 1) * G; e += 32 * G) {
      const int h = e % G;
      if (b0 + h < B) xi[(e / G) * sB + b0 + h] = s[h * stride + tri_row(i) + e / G];
    }
  }
}

// v[rr] for a run-time rr, picked by selects: indexing the array by a
// run-time value would move it from registers to local memory
template <typename T, int R>
__device__ __forceinline__ T slot(const T (&v)[R], int rr) {
  T x = v[0];
#pragma unroll
  for (int q = 1; q < R; ++q) x = rr == q ? v[q] : x;
  return x;
}

template <typename T, int G, int R>
__global__ void __launch_bounds__(32 * G)
solve_bl_smem_kernel(const T* __restrict__ L, const T* __restrict__ dinv,
                     const T* __restrict__ Rhs, T* __restrict__ V, int m, int B, int k_rhs) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G is a power of two <= 32");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // G packed triangles, lane-major
  const int stride = tri_stride(m, G);
  const int t = threadIdx.x & 31;  // owns rows t + 32 * r
  const int g = threadIdx.x / 32;  // the warp's lane within the group
  const int b0 = blockIdx.x * G;
  const int b = b0 + g;
  const bool live = b < B;
  const size_t sB = static_cast<size_t>(B);
  const size_t sm = static_cast<size_t>(m);

  stage_tri<T, G, 32 * G>(s, L, m, B, b0, [stride](int p, int h) { return h * stride + p; });
  T d[R];   // dinv of the owned rows
  int off[R];  // where the owned rows start in the triangle
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = t + 32 * r;
    d[r] = live && i < m ? dinv[i * sB + b] : T(0);
    off[r] = tri_row(i);
  }
  cp_async_wait_all();
  __syncthreads();  // the only block barrier: from here on each warp is on its own
  if (!live) return;
  const T* sl = s + g * stride;

  for (int c0 = 0; c0 < k_rhs; c0 += kSolveRhs) {
    const int kc = min(kSolveRhs, k_rhs - c0);
    T v[kSolveRhs][R];
#pragma unroll
    for (int q = 0; q < kSolveRhs; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = t + 32 * r;
        v[q][r] = q < kc && i < m ? Rhs[((c0 + q) * sm + i) * sB + b] : T(0);
      }
    }
    // forward, column-oriented: w_k = v_k * dinv[k]; v_i -= L[i, k] * w_k
    for (int k = 0; k < m; ++k) {
      const int owner = k & 31;
      const int kr = k >> 5;
      const T dk = slot(d, kr);
      T wk[kSolveRhs];
#pragma unroll
      for (int q = 0; q < kSolveRhs; ++q) {
        wk[q] = __shfl_sync(0xffffffffu, slot(v[q], kr) * dk, owner);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r == kr && t == owner) v[q][r] = wk[q];  // the owner keeps w_k
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = t + 32 * r;
        if (i > k && i < m) {
          const T lik = sl[off[r] + k];
#pragma unroll
          for (int q = 0; q < kSolveRhs; ++q) v[q][r] -= lik * wk[q];
        }
      }
    }
    // backward, right-looking: v_i = w_i * dinv[i]; w_j -= L[i, j] * v_i
    for (int i = m - 1; i >= 0; --i) {
      const int owner = i & 31;
      const int ir = i >> 5;
      const T di = slot(d, ir);
      const T* si = sl + tri_row(i);
      T vi[kSolveRhs];
#pragma unroll
      for (int q = 0; q < kSolveRhs; ++q) {
        vi[q] = __shfl_sync(0xffffffffu, slot(v[q], ir) * di, owner);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r == ir && t == owner) v[q][r] = vi[q];  // the owner keeps v_i
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = t + 32 * r;
        if (j < i) {
          const T lij = si[j];
#pragma unroll
          for (int q = 0; q < kSolveRhs; ++q) v[q][r] -= lij * vi[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kSolveRhs; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = t + 32 * r;
        if (q < kc && i < m) V[((c0 + q) * sm + i) * sB + b] = v[q][r];
      }
    }
  }
}

// Shared memory of one block of either kernel, in bytes: G lane-major
// triangles; ops/batchlast.py plans with the same formula (smem_bytes).
template <typename T>
size_t tri_smem_bytes(int m, int G) {
  return static_cast<size_t>(tri_stride(m, G)) * G * sizeof(T);
}

constexpr int kMaxDevices = 64;

// Opt a kernel in to the whole of a block's shared memory on sm_90 and to
// the carve-out that leaves the most of the SM to shared memory, once per
// device: `done` is the calling launcher's own flags, so the launches after
// the first cost no attribute calls.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  constexpr int kSmemOptIn = 232448;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int G, int NP>
int launch_chol_smem_gr(const void* M, const void* reg, void* L, void* dinv, int m, int B,
                        void* stream) {
  static bool done[kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(chol_bl_smem_kernel<T, G, NP>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid = static_cast<unsigned int>((B + G - 1) / G);
  chol_bl_smem_kernel<T, G, NP><<<grid, 32 * G, tri_smem_bytes<T>(m, G),
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(M), static_cast<const T*>(reg), static_cast<T*>(L),
      static_cast<T*>(dinv), m, B);
  return static_cast<int>(cudaGetLastError());
}

// row pairs a factor thread owns: NP = ceil(m / 64), rounded up to a built size
template <typename T, int G>
int launch_chol_smem_g(const void* M, const void* reg, void* L, void* dinv, int m, int B,
                       void* stream) {
  if (m <= 64) return launch_chol_smem_gr<T, G, 1>(M, reg, L, dinv, m, B, stream);
  if (m <= 128) return launch_chol_smem_gr<T, G, 2>(M, reg, L, dinv, m, B, stream);
  if (m <= 384) return launch_chol_smem_gr<T, G, 6>(M, reg, L, dinv, m, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int G, int R>
int launch_solve_smem_gr(const void* L, const void* dinv, const void* Rhs, void* V, int m,
                         int B, int k_rhs, void* stream) {
  static bool done[kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(solve_bl_smem_kernel<T, G, R>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid = static_cast<unsigned int>((B + G - 1) / G);
  solve_bl_smem_kernel<T, G, R><<<grid, 32 * G, tri_smem_bytes<T>(m, G),
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(dinv), static_cast<const T*>(Rhs),
      static_cast<T*>(V), m, B, k_rhs);
  return static_cast<int>(cudaGetLastError());
}

// rows a solve thread owns: R = ceil(m / 32), rounded up to a built size
template <typename T, int G>
int launch_solve_smem_g(const void* L, const void* dinv, const void* Rhs, void* V, int m, int B,
                        int k_rhs, void* stream) {
  if (m <= 64) return launch_solve_smem_gr<T, G, 2>(L, dinv, Rhs, V, m, B, k_rhs, stream);
  if (m <= 128) return launch_solve_smem_gr<T, G, 4>(L, dinv, Rhs, V, m, B, k_rhs, stream);
  if (m <= 352) return launch_solve_smem_gr<T, G, 11>(L, dinv, Rhs, V, m, B, k_rhs, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Host-side launches with the lane-group size G chosen by the caller (1,
// 2, 4 or 8); each returns cudaGetLastError() (0 = launched) and does not
// synchronise.
template <typename T>
int launch_chol_bl_smem(const void* M, const void* reg, void* L, void* dinv, int m, int B,
                        int G, void* stream) {
  cudaGetLastError();  // clear a stale error so the return names this launch
  switch (G) {
    case 1: return launch_chol_smem_g<T, 1>(M, reg, L, dinv, m, B, stream);
    case 2: return launch_chol_smem_g<T, 2>(M, reg, L, dinv, m, B, stream);
    case 4: return launch_chol_smem_g<T, 4>(M, reg, L, dinv, m, B, stream);
    case 8: return launch_chol_smem_g<T, 8>(M, reg, L, dinv, m, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_solve_bl_smem(const void* L, const void* dinv, const void* Rhs, void* V, int m, int B,
                         int k_rhs, int G, void* stream) {
  cudaGetLastError();
  switch (G) {
    case 1: return launch_solve_smem_g<T, 1>(L, dinv, Rhs, V, m, B, k_rhs, stream);
    case 2: return launch_solve_smem_g<T, 2>(L, dinv, Rhs, V, m, B, k_rhs, stream);
    case 4: return launch_solve_smem_g<T, 4>(L, dinv, Rhs, V, m, B, k_rhs, stream);
    case 8: return launch_solve_smem_g<T, 8>(L, dinv, Rhs, V, m, B, k_rhs, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
