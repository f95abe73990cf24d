// Batch-last Cholesky factor, k-RHS solve and the two fused kernels with
// each lane's triangle in shared memory: the Hopper design of chol_bl /
// solve_bl (float, in batchlast.cu) and df_chol_bl / df_solve_bl (double,
// in df64.cu), and of facsol_bl / fused_factor_bl (float, batchlast.cu).
//
// Replaces, as the default route at every m whose one-lane triangle fits
// in shared memory (m <= 128 for fused_factor_bl):
//   chol_bl_smem    <- pycllp_tpu/ops/batchlast.py:223 (_chol_bl)
//                      pycllp_tpu/ops/df64.py:264      (_df_chol_bl)
//   solve_bl_smem   <- pycllp_tpu/ops/batchlast.py:273 (_solve_bl)
//                      pycllp_tpu/ops/df64.py:295      (_df_solve_bl)
//   facsol_bl_smem  <- pycllp_tpu/ops/batchlast.py:247 (_facsol_bl)
//   fused_factor_bl_smem <- pycllp_tpu/ops/batchlast.py:195 (_fused_factor_bl)
// The streaming kernels of batchlast.cuh and batchlast.cu stay for the m
// whose triangle does not fit (m > 340 in float, m > 240 in double, at one
// lane per block; m > 128 for fused_factor_bl).  The host picks the design
// by shape alone and the lane-group size G from (shape, B, SM count); see
// lane_plan in ops/batchlast.py.
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
// All kernels run a block of G warps, one lane (instance) a warp, G a
// template parameter (1, 2, 4 or 8).  The block copies its G lanes' lower triangles into shared memory once, with
// cp.async, 4 or 8 bytes an element: each entry's G lanes are one
// contiguous segment of device memory, and no register holds the data in
// flight.  Lanes past B are zero-filled, their warps idle, and nothing of
// theirs is written back.  The triangles are packed lane-major: lane g's
// entry (i, j), j <= i, at [g * stride + i(i+1)/2 + j], stride = the
// triangle rounded up to 32 entries plus 32 / G, so the copy's writes fall
// in distinct banks.  A row of a triangle is contiguous, and a column is
// conflict-free too: i(i+1)/2 runs through every residue mod 32 (and 16)
// as i runs through 32 consecutive values.  At m = 64 a lane's triangle is
// 8,320 B in float and 16,640 B in double, so G = 8 (float) or G = 4
// (double) is ~67 KB a block and three blocks share an SM.  After the copy
// the warps never meet at a block barrier until the write-back: each
// warp's steps are ordered by __syncwarp and shuffles only.
//
// The factor (lane_factor, one __device__ routine that chol_bl_smem,
// facsol_bl_smem and fused_factor_bl_smem all run, so every L[i, j] gets
// the same FMAs in the same pivot order whichever kernel factors it):
// thread t of a warp owns the rows t + 64 q and 63 - t + 64 q (q < NP, a
// template parameter: 1 up to m = 64, 2 up to 128, 6 up to 384), so every
// thread's rows hold the same number of entries.  The pivots run in panels
// of kPanel.  Per pivot k of a panel every thread reads the pivot (plus
// reg) and scales column k on its own rows, keeping L[i, k] in a register;
// one __syncwarp; then it applies pivot k to its rows of the panel's later
// columns, reading L[c, k] as a broadcast; another __syncwarp.  After the
// panel one pass applies its kPanel pivots to every trailing entry (i, j),
// j past the panel: per column j the warp reads the kPanel values L[j, p]
// as broadcasts, and each thread reads its L[i, j] once, subtracts the
// kPanel products in pivot order and writes it once.  Every L[i, j]
// receives the same updates in the same pivot order as _chol_bl_plain
// (right-looking), FP32 FMAs in float and FP64 in double (no tensor-core
// path).  A caller may ride the pivots (the Ride argument): after pivot
// k's column is scaled it sees k, the reciprocal pivot and the column on
// the thread's rows.  L's lower triangle is written once at the end, dinv
// once per pivot.
//
// solve_bl_smem: thread t of a warp owns rows i = t + 32 r (r < R, a
// template parameter: 2 up to m = 64, 4 up to 128, 11 up to 352): their
// right-hand sides and dinv live in registers.  The forward pass is
// left-looking, as _solve_bl_plain and the reference's _solve_kernel: per
// row i every thread takes the partial dot of the staged row L[i, :i]
// (contiguous, so conflict-free) with the w_j it owns, j < i, a butterfly
// of __shfl_xor_sync gives every thread the whole dot, and the owner of
// row i sets w_i = (v_i - dot) * dinv[i]: one rounded dot per row, then
// one subtraction.  The dot is summed as a tree over the threads, not in
// the CPU's order, so parity is not bitwise.  The backward pass is
// right-looking over rows: v_i = w_i * dinv[i] from its owner by shuffle,
// then v_j -= L[i, j] * v_i on the rows j < i.  A backward step's critical
// path is a shuffle and two FMAs, a forward step's five shuffles; the L
// reads do not depend on either.  More right-hand sides than kSolveRhs
// run in turns on the staged L.
//
// facsol_bl_smem (replaces _facsol_kernel): the block stages M, runs
// lane_factor on it, and the forward substitution rides each pivot, which
// is _facsol_kernel's own column-oriented order: the owner of row k sets
// w_k = v_k * inv and a shuffle hands it to the warp, and each thread
// applies v_i -= L[i, k] * w_k to its rows i > k with the scaled column
// value the factor already holds in a register, so the forward pass reads
// nothing extra.  V (kSolveRhs right-hand sides at a time) and dinv sit in
// registers on the factor's rows; more right-hand sides run in turns, with
// a forward pass in the same column order on the staged triangle.  The
// backward pass is right-looking on the staged triangle.  L's lower
// triangle goes back into M's storage (the reference aliases M to L);
// dinv and V are written once.  Its bound is chol_bl's bytes plus R and V
// (294 MB at k = 2, B = 16,384: 0.088 ms); the streaming facsol ran the
// pivots in device memory (~3.5 ms).
//
// fused_factor_bl_smem (replaces _fused_factor_kernel): the block forms
// each lane's lower triangle M[i, j] = sum_q W[i*m + j, q] * dT[q, b],
// j <= i, straight into its shared-memory triangle, then runs lane_factor:
// M never exists in device memory.  Each thread forms whole entries for
// all G lanes of its block, four entries at a time, the 4 * G dot products
// over q in registers, FP32 FMAs in q order from zero (the streaming
// kernel's order; no TF32, no tensor cores).  dT[:, block's lanes] is
// staged once in shared memory (q-major, lanes contiguous), and every
// thread of a warp reads the same dT row, a broadcast that serves 4 * G
// FMAs.  W comes packed and transposed, Wp = (n, m(m+1)/2) of W's
// lower-triangle rows (BatchLastKernels.prepare packs it once per A,
// ~1 MB): a warp's 32 neighbouring entries read 32 neighbouring floats of
// each column q, so every L2 sector is used whole; each block asks for Wp
// once for its G lanes (1.06 MB at m = 64, n = 128).  What bounds it:
// m(m+1)/2 * n FMAs per lane (266K at m = 64, n = 128; 0.13 ms of FP32
// issue at B = 16,384), then the factor.  Read as W's rows (one thread a
// row, 16 bytes of each 32-byte sector) a 24-lane block was the fastest
// and the 8-lane one 40% slower; read packed and transposed, 8-, 12- and
// 24-lane blocks are within 5% of each other on the H100, so G stays at
// the factor's sizes (1 to 8) and the plan is chol_bl's.  The staged
// triangle limits G as m grows, and each block's W grows as m^2 * n, so
// past m = 128 the streaming kernel, which shares each W tile among 32
// lanes, takes over.
//
// Semantics are those of batchlast.cuh: reg[b] is added at each pivot
// read, a pivot <= 0 or NaN writes NaN to its diagonal and dinv and so
// poisons its own lane only, and only the lower triangle of L and dinv
// carry meaning.  These kernels leave L's upper triangle unwritten (the
// streaming chol_bl kept M's values there, the streaming fused_factor_bl
// wrote zeros, and facsol_bl leaves M's values): no consumer reads it
// (ops/batchlast.py solve, ops/df64.py solve, ops/mixed.py's f32 factor
// all hand L to the solve, which reads L[i, :i] and dinv).

#pragma once

#include "batchlast.cuh"

namespace {

constexpr int kPanel = 4;     // pivots the factor applies to the trailing entries in one pass
constexpr int kSolveRhs = 2;  // right-hand sides a warp holds at once (solve, facsol)
constexpr int kFormCols = 4;  // fused_factor_bl: W columns a thread holds at once, per entry

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

// Write the G staged triangles back as the lower triangle of the
// batch-last (m, m, B) tensor L, lanes b0 .. b0 + G - 1, lanes past B
// skipped; the block's 32 G threads share the writes.
template <typename T, int G>
__device__ __forceinline__ void write_tri(T* L, const T* __restrict__ s, int stride, int m, int B,
                                          int b0) {
  const size_t sB = static_cast<size_t>(B);
  for (int i = 0; i < m; ++i) {
    T* xi = L + static_cast<size_t>(i) * m * sB;
    for (int e = threadIdx.x; e < (i + 1) * G; e += 32 * G) {
      const int h = e % G;
      if (b0 + h < B) xi[(e / G) * sB + b0 + h] = s[h * stride + tri_row(i) + e / G];
    }
  }
}

// rows a factor thread owns: pairs (t + 64 q, 63 - t + 64 q), q < NP, so
// the row lengths of every thread add up to the same count
__device__ __forceinline__ int pair_row(int t, int rr) {
  return (rr & 1 ? 63 - t : t) + 64 * (rr >> 1);
}

// the thread that owns row k under pair_row, and the slot rr it keeps it in
__device__ __forceinline__ int pair_owner(int k) {
  const int kk = k & 63;
  return kk < 32 ? kk : 63 - kk;
}

__device__ __forceinline__ int pair_slot(int k) { return 2 * (k >> 6) + ((k & 63) >= 32); }

// v[rr] for a run-time rr, picked by selects: indexing the array by a
// run-time value would move it from registers to local memory
template <typename T, int R>
__device__ __forceinline__ T slot(const T (&v)[R], int rr) {
  T x = v[0];
#pragma unroll
  for (int q = 1; q < R; ++q) x = rr == q ? v[q] : x;
  return x;
}

// v[rr] = x on thread `owner` only, for a run-time rr
template <typename T, int R>
__device__ __forceinline__ void keep(T (&v)[R], int rr, int t, int owner, T x) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (q == rr && t == owner) v[q] = x;
  }
}

// Nothing rides the pivots: the plain factor.
struct NoRide {
  template <typename T, int R>
  __device__ __forceinline__ void pivot(int, T, const T (&)[R], const int (&)[R]) {}
};

// The lane-group factor of one lane: its triangle sl (staged, lane-major)
// becomes L, dinv[k * sB + b] gets the reciprocal pivots, and ride.pivot(k,
// inv, col, row) runs after pivot k's column is scaled, with col[q] =
// L[row[q], k] for the owned rows below k (0 elsewhere).  The whole warp
// (thread t = its lane index) calls it.
template <typename T, int NP, typename Ride>
__device__ __forceinline__ void lane_factor(T* __restrict__ sl, T r, T* __restrict__ dinv,
                                            size_t sB, int b, int m, int t, Ride& ride) {
  constexpr int R = 2 * NP;  // rows a thread owns
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
        T col[R];
#pragma unroll
        for (int q = 0; q < R; ++q) col[q] = a[q][p];
        ride.pivot(k, inv, col, row);
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

template <typename T, int G, int NP>
__global__ void __launch_bounds__(32 * G)
chol_bl_smem_kernel(const T* __restrict__ M, const T* __restrict__ reg, T* __restrict__ L,
                    T* __restrict__ dinv, int m, int B) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G is a power of two <= 32");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // G packed triangles, lane-major
  const int stride = tri_stride(m, G);
  const int t = threadIdx.x & 31;
  const int g = threadIdx.x / 32;  // the warp's lane within the group
  const int b0 = blockIdx.x * G;
  const int b = b0 + g;
  const bool live = b < B;

  stage_tri<T, G, 32 * G>(s, M, m, B, b0, [stride](int p, int h) { return h * stride + p; });
  const T r = live ? reg[b] : T(0);
  cp_async_wait_all();
  __syncthreads();  // from here until the write-back each warp is on its own

  if (live) {
    NoRide ride;
    lane_factor<T, NP>(s + g * stride, r, dinv, static_cast<size_t>(B), b, m, t, ride);
  }
  __syncthreads();
  write_tri<T, G>(L, s, stride, m, B, b0);  // L's lower triangle, written once
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
  T d[R];  // dinv of the owned rows
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = t + 32 * r;
    d[r] = live && i < m ? dinv[i * sB + b] : T(0);
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
    // forward, left-looking: w_i = (v_i - L[i, :i] . w[:i]) * dinv[i]
    for (int i = 0; i < m; ++i) {
      const int owner = i & 31;
      const int ir = i >> 5;
      const T* si = sl + tri_row(i);
      T dot[kSolveRhs];
#pragma unroll
      for (int q = 0; q < kSolveRhs; ++q) dot[q] = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = t + 32 * r;
        if (j < i) {
          const T lij = si[j];
#pragma unroll
          for (int q = 0; q < kSolveRhs; ++q) dot[q] += lij * v[q][r];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int q = 0; q < kSolveRhs; ++q) dot[q] += __shfl_xor_sync(0xffffffffu, dot[q], o);
      }
      const T di = slot(d, ir);
#pragma unroll
      for (int q = 0; q < kSolveRhs; ++q) keep(v[q], ir, t, owner, (slot(v[q], ir) - dot[q]) * di);
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
        keep(v[q], ir, t, owner, vi[q]);  // the owner keeps v_i
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

// ---------------------------------------------------------------------------
// facsol_bl: the factor with the forward substitution riding its pivots
// ---------------------------------------------------------------------------

// The forward substitution of facsol_bl on the factor's rows (pair_row):
// w_k = v_k * inv from the owner of row k, then v_i -= L[i, k] * w_k on the
// rows i > k, with L[i, k] the column value the factor holds; the owner
// also keeps inv as its row's dinv for the backward pass.
template <typename T, int R>
struct RideForward {
  T (&v)[kSolveRhs][R];
  T (&d)[R];
  int t;

  __device__ __forceinline__ void pivot(int k, T inv, const T (&col)[R], const int (&row)[R]) {
    const int owner = pair_owner(k);
    const int kr = pair_slot(k);
    keep(d, kr, t, owner, inv);
#pragma unroll
    for (int c = 0; c < kSolveRhs; ++c) {
      const T wk = __shfl_sync(0xffffffffu, slot(v[c], kr) * inv, owner);
      keep(v[c], kr, t, owner, wk);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (row[q] > k) v[c][q] -= col[q] * wk;
      }
    }
  }
};

// right-hand sides c0 .. c0 + kSolveRhs - 1 (those below k_rhs) of lane b
// on the factor's rows, or into V
template <typename T, int R>
__device__ __forceinline__ void load_pair_rhs(T (&v)[kSolveRhs][R], const T* __restrict__ Rhs,
                                              int c0, int k_rhs, int t, int m, int B, int b) {
  const size_t sB = static_cast<size_t>(B);
#pragma unroll
  for (int c = 0; c < kSolveRhs; ++c) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = pair_row(t, q);
      v[c][q] = c0 + c < k_rhs && i < m
                    ? Rhs[(static_cast<size_t>(c0 + c) * m + i) * sB + b] : T(0);
    }
  }
}

template <typename T, int R>
__device__ __forceinline__ void store_pair_rhs(T* __restrict__ V, const T (&v)[kSolveRhs][R],
                                               int c0, int k_rhs, int t, int m, int B, int b) {
  const size_t sB = static_cast<size_t>(B);
#pragma unroll
  for (int c = 0; c < kSolveRhs; ++c) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = pair_row(t, q);
      if (c0 + c < k_rhs && i < m) V[(static_cast<size_t>(c0 + c) * m + i) * sB + b] = v[c][q];
    }
  }
}

// The forward pass on the staged (factored) triangle, in the order the
// pivots ride: for k = 0 .. m-1, w_k = v_k * dinv[k]; v_i -= L[i, k] * w_k.
template <typename T, int R>
__device__ __forceinline__ void pair_forward(const T* __restrict__ sl, T (&v)[kSolveRhs][R],
                                             const T (&d)[R], int t, int m) {
  for (int k = 0; k < m; ++k) {
    const int owner = pair_owner(k);
    const int kr = pair_slot(k);
    const T dk = slot(d, kr);
    T wk[kSolveRhs];
#pragma unroll
    for (int c = 0; c < kSolveRhs; ++c) {
      wk[c] = __shfl_sync(0xffffffffu, slot(v[c], kr) * dk, owner);
      keep(v[c], kr, t, owner, wk[c]);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = pair_row(t, q);
      if (i > k && i < m) {
        const T lik = sl[tri_row(i) + k];
#pragma unroll
        for (int c = 0; c < kSolveRhs; ++c) v[c][q] -= lik * wk[c];
      }
    }
  }
}

// The backward pass, right-looking over the rows of the staged triangle:
// v_i = w_i * dinv[i] from the owner of row i; v_j -= L[i, j] * v_i, j < i.
template <typename T, int R>
__device__ __forceinline__ void pair_backward(const T* __restrict__ sl, T (&v)[kSolveRhs][R],
                                              const T (&d)[R], int t, int m) {
  for (int i = m - 1; i >= 0; --i) {
    const int owner = pair_owner(i);
    const int ir = pair_slot(i);
    const T di = slot(d, ir);
    const T* si = sl + tri_row(i);
    T vi[kSolveRhs];
#pragma unroll
    for (int c = 0; c < kSolveRhs; ++c) {
      vi[c] = __shfl_sync(0xffffffffu, slot(v[c], ir) * di, owner);
      keep(v[c], ir, t, owner, vi[c]);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = pair_row(t, q);
      if (j < i) {
        const T lij = si[j];
#pragma unroll
        for (int c = 0; c < kSolveRhs; ++c) v[c][q] -= lij * vi[c];
      }
    }
  }
}

// L is M on entry and L on exit (factored in place).
template <typename T, int G, int NP>
__global__ void __launch_bounds__(32 * G)
facsol_bl_smem_kernel(T* L, const T* __restrict__ reg, const T* __restrict__ Rhs,
                      T* __restrict__ dinv, T* __restrict__ V, int m, int B, int k_rhs) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G is a power of two <= 32");
  constexpr int R = 2 * NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // G packed triangles, lane-major
  const int stride = tri_stride(m, G);
  const int t = threadIdx.x & 31;
  const int g = threadIdx.x / 32;
  const int b0 = blockIdx.x * G;
  const int b = b0 + g;
  const bool live = b < B;

  stage_tri<T, G, 32 * G>(s, L, m, B, b0, [stride](int p, int h) { return h * stride + p; });
  const T r = live ? reg[b] : T(0);
  T v[kSolveRhs][R];  // right-hand sides, then w, then v, on the factor's rows
  T d[R];             // dinv of those rows
#pragma unroll
  for (int q = 0; q < R; ++q) d[q] = T(0);
  if (live) load_pair_rhs(v, Rhs, 0, k_rhs, t, m, B, b);
  cp_async_wait_all();
  __syncthreads();  // from here until the write-back each warp is on its own

  if (live) {
    T* sl = s + g * stride;
    RideForward<T, R> ride{v, d, t};
    lane_factor<T, NP>(sl, r, dinv, static_cast<size_t>(B), b, m, t, ride);
    pair_backward(sl, v, d, t, m);
    store_pair_rhs(V, v, 0, k_rhs, t, m, B, b);
    for (int c0 = kSolveRhs; c0 < k_rhs; c0 += kSolveRhs) {
      load_pair_rhs(v, Rhs, c0, k_rhs, t, m, B, b);
      pair_forward(sl, v, d, t, m);
      pair_backward(sl, v, d, t, m);
      store_pair_rhs(V, v, c0, k_rhs, t, m, B, b);
    }
  }
  __syncthreads();
  write_tri<T, G>(L, s, stride, m, B, b0);  // L's lower triangle into M's storage
}

// ---------------------------------------------------------------------------
// fused_factor_bl: M = W dT formed in shared memory, then the factor
// ---------------------------------------------------------------------------

// E entries e0, e0 + de, ... of the G staged lanes' M, formed in
// registers and stored into the triangles: acc[r][h] = sum_q Wp[q, e] *
// dT[q, h], FMAs in q order from zero.  Wp is W's lower-triangle rows,
// packed and transposed, (n, n_entries): a warp's 32 entries read 32
// neighbouring floats of each column q.  One dT row read (a broadcast)
// serves E * G FMAs.
template <int G, int E>
__device__ __forceinline__ void form_entries(float* __restrict__ s, const float* __restrict__ ds,
                                             const float* __restrict__ Wp, int e0, int de,
                                             int n_entries, int n, int stride) {
  float acc[E][G];
#pragma unroll
  for (int r = 0; r < E; ++r) {
#pragma unroll
    for (int h = 0; h < G; ++h) acc[r][h] = 0.0f;
  }
  const size_t sE = static_cast<size_t>(n_entries);
  for (int q0 = 0; q0 < n; q0 += kFormCols) {
    float wq[E][kFormCols];
#pragma unroll
    for (int r = 0; r < E; ++r) {
#pragma unroll
      for (int c = 0; c < kFormCols; ++c) {
        wq[r][c] = q0 + c < n ? __ldg(Wp + (q0 + c) * sE + e0 + r * de) : 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < kFormCols; ++c) {
      const float* dq = ds + (q0 + c) * G;  // one address for the whole warp: a broadcast
      if constexpr (G % 4 == 0) {
#pragma unroll
        for (int h = 0; h < G; h += 4) {
          const float4 d4 = *reinterpret_cast<const float4*>(dq + h);
#pragma unroll
          for (int r = 0; r < E; ++r) {
            acc[r][h] = fmaf(wq[r][c], d4.x, acc[r][h]);
            acc[r][h + 1] = fmaf(wq[r][c], d4.y, acc[r][h + 1]);
            acc[r][h + 2] = fmaf(wq[r][c], d4.z, acc[r][h + 2]);
            acc[r][h + 3] = fmaf(wq[r][c], d4.w, acc[r][h + 3]);
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float dh = dq[h];
#pragma unroll
          for (int r = 0; r < E; ++r) acc[r][h] = fmaf(wq[r][c], dh, acc[r][h]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
#pragma unroll
    for (int h = 0; h < G; ++h) s[h * stride + e0 + r * de] = acc[r][h];
  }
}

// where the staged dT starts after the G triangles (a multiple of 4 floats)
__host__ __device__ __forceinline__ int fused_dt_offset(int m, int G) {
  return (tri_stride(m, G) * G + 3) / 4 * 4;
}

// dT rows staged: n rounded up to whole kFormCols chunks
__host__ __device__ __forceinline__ int fused_dt_rows(int n) {
  return (n + kFormCols - 1) / kFormCols * kFormCols;
}

template <typename T, int G, int NP>
__global__ void __launch_bounds__(32 * G)
fused_factor_bl_smem_kernel(const T* __restrict__ Wp, const T* __restrict__ dT,
                            const T* __restrict__ reg, T* __restrict__ L,
                            T* __restrict__ dinv, int m, int n, int B) {
  static_assert(sizeof(T) == 4, "float only: dT is read as float4");
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G is a power of two <= 32");
  constexpr int NT = 32 * G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s = reinterpret_cast<float*>(smem_raw);  // G packed triangles, lane-major
  float* ds = s + fused_dt_offset(m, G);           // (n rows, G lanes): dT, zero past n and B
  const int stride = tri_stride(m, G);
  const int t = threadIdx.x & 31;
  const int g = threadIdx.x / 32;
  const int b0 = blockIdx.x * G;
  const int b = b0 + g;
  const bool live = b < B;
  const size_t sB = static_cast<size_t>(B);
  const int nq = fused_dt_rows(n);

  for (int e = threadIdx.x; e < nq * G; e += NT) {
    const int q = e / G;
    const int h = e % G;
    ds[e] = q < n && b0 + h < B ? dT[q * sB + b0 + h] : 0.0f;
  }
  __syncthreads();

  // M[i, j, b0 + h] = sum_q W[i*m + j, q] * dT[q, b0 + h]: thread x forms
  // the packed entries e = x + NT k, every lane h of the block at once,
  // four entries at a time (32 accumulators at G = 8, so three 8-lane
  // blocks fit an SM's registers), then pairs, then one.  The tail's shape
  // matters even where it does no work: with a loop of single entries in
  // place of the pair loop and the last `if`, chip_smoke.py timed the
  // kernel at 1.06 ms instead of 0.90 (m = 64, B = 16,384, H100 SXM at
  // 700 W), for the same entries.
  const int n_entries = tri_row(m);
  int e = threadIdx.x;
  for (; e + 3 * NT < n_entries; e += 4 * NT) form_entries<G, 4>(s, ds, Wp, e, NT, n_entries, n, stride);
  for (; e + NT < n_entries; e += 2 * NT) form_entries<G, 2>(s, ds, Wp, e, NT, n_entries, n, stride);
  if (e < n_entries) form_entries<G, 1>(s, ds, Wp, e, NT, n_entries, n, stride);
  const float r = live ? reg[b] : 0.0f;
  __syncthreads();  // every lane's M is formed

  if (live) {
    NoRide ride;
    lane_factor<float, NP>(s + g * stride, r, dinv, sB, b, m, t, ride);
  }
  __syncthreads();
  write_tri<float, G>(L, s, stride, m, B, b0);  // L's lower triangle, written once
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Shared memory of one chol / solve / facsol block, in bytes: G lane-major
// triangles; ops/batchlast.py plans with the same formula (smem_bytes).
template <typename T>
size_t tri_smem_bytes(int m, int G) {
  return static_cast<size_t>(tri_stride(m, G)) * G * sizeof(T);
}

// Shared memory of one fused_factor_bl block: the G triangles, then dT's
// rows for the G lanes (ops/batchlast.py: fused_smem_bytes).
inline size_t fused_smem_bytes(int m, int n, int G) {
  return (static_cast<size_t>(fused_dt_offset(m, G)) + static_cast<size_t>(fused_dt_rows(n)) * G) *
         sizeof(float);
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

template <typename T, int G, int NP>
int launch_facsol_smem_gr(void* L, const void* reg, const void* Rhs, void* dinv, void* V, int m,
                          int B, int k_rhs, void* stream) {
  static bool done[kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(facsol_bl_smem_kernel<T, G, NP>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid = static_cast<unsigned int>((B + G - 1) / G);
  facsol_bl_smem_kernel<T, G, NP><<<grid, 32 * G, tri_smem_bytes<T>(m, G),
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(L), static_cast<const T*>(reg), static_cast<const T*>(Rhs),
      static_cast<T*>(dinv), static_cast<T*>(V), m, B, k_rhs);
  return static_cast<int>(cudaGetLastError());
}

// row pairs a facsol thread owns: those of the factor (launch_chol_smem_g)
template <typename T, int G>
int launch_facsol_smem_g(void* L, const void* reg, const void* Rhs, void* dinv, void* V, int m,
                         int B, int k_rhs, void* stream) {
  if (m <= 64) return launch_facsol_smem_gr<T, G, 1>(L, reg, Rhs, dinv, V, m, B, k_rhs, stream);
  if (m <= 128) return launch_facsol_smem_gr<T, G, 2>(L, reg, Rhs, dinv, V, m, B, k_rhs, stream);
  if (m <= 384) return launch_facsol_smem_gr<T, G, 6>(L, reg, Rhs, dinv, V, m, B, k_rhs, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int G, int NP>
int launch_fused_smem_gr(const void* Wp, const void* dT, const void* reg, void* L, void* dinv,
                         int m, int n, int B, void* stream) {
  static bool done[kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(fused_factor_bl_smem_kernel<T, G, NP>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid = static_cast<unsigned int>((B + G - 1) / G);
  fused_factor_bl_smem_kernel<T, G, NP><<<grid, 32 * G, fused_smem_bytes(m, n, G),
                                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Wp), static_cast<const T*>(dT), static_cast<const T*>(reg),
      static_cast<T*>(L), static_cast<T*>(dinv), m, n, B);
  return static_cast<int>(cudaGetLastError());
}

// fused_factor_bl's row pairs: NP = 1 up to m = 64, 2 up to 128 (the
// streaming kernel takes the larger m)
template <typename T, int G>
int launch_fused_smem_g(const void* Wp, const void* dT, const void* reg, void* L, void* dinv,
                        int m, int n, int B, void* stream) {
  if (m <= 64) return launch_fused_smem_gr<T, G, 1>(Wp, dT, reg, L, dinv, m, n, B, stream);
  if (m <= 128) return launch_fused_smem_gr<T, G, 2>(Wp, dT, reg, L, dinv, m, n, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Host-side launches with the lane-group size G chosen by the caller (1,
// 2, 4 or 8); each returns
// cudaGetLastError() (0 = launched) and does not synchronise.
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

template <typename T>
int launch_facsol_bl_smem(void* L, const void* reg, const void* Rhs, void* dinv, void* V,
                                 int m, int B, int k_rhs, int G, void* stream) {
  cudaGetLastError();
  switch (G) {
    case 1: return launch_facsol_smem_g<T, 1>(L, reg, Rhs, dinv, V, m, B, k_rhs, stream);
    case 2: return launch_facsol_smem_g<T, 2>(L, reg, Rhs, dinv, V, m, B, k_rhs, stream);
    case 4: return launch_facsol_smem_g<T, 4>(L, reg, Rhs, dinv, V, m, B, k_rhs, stream);
    case 8: return launch_facsol_smem_g<T, 8>(L, reg, Rhs, dinv, V, m, B, k_rhs, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_fused_factor_bl_smem(const void* Wp, const void* dT, const void* reg, void* L,
                                       void* dinv, int m, int n, int B, int G, void* stream) {
  cudaGetLastError();
  switch (G) {
    case 1: return launch_fused_smem_g<T, 1>(Wp, dT, reg, L, dinv, m, n, B, stream);
    case 2: return launch_fused_smem_g<T, 2>(Wp, dT, reg, L, dinv, m, n, B, stream);
    case 4: return launch_fused_smem_g<T, 4>(Wp, dT, reg, L, dinv, m, n, B, stream);
    case 8: return launch_fused_smem_g<T, 8>(Wp, dT, reg, L, dinv, m, n, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
