// Lane matvec for per-instance A on Hopper (sm_90a): A·x, Aᵀ·y and the
// normal product A(d∘Aᵀv) + δv, each lane's A read once per product.
//
// Replaces no TPU kernel.  The reference leaves its per-instance matvecs
// to XLA's einsum (pycllp_tpu/ops/batchlast.py, the 3-D branch of _mv and
// _rmv); on the card torch.einsum hands them to cuBLAS's batched gemv,
// which reads A twice for each normal product the mixed crossover refines
// with (an rmv launch, then an mv launch).  ops/lanemv.py is the wrapper
// and holds the plain versions.
//
// Bound: HBM bytes.  A product reads each lane's (m, n) A once, plus its
// vectors, and writes an m or n vector: 2 flops for every 4 (f32) or 8
// (f64) bytes of A, far below the card's ridge.  At the padded netlib
// shape (24,576 lanes of 56 x 153) one pass is 842.3 MB in f32 and
// 1,684.5 MB in f64: 0.251 and 0.503 ms at 3.35 TB/s.  The only levers
// are to stream the slab at the card's bandwidth and to read it once
// where the einsum route read it twice.
//
// Design.  Persistent blocks of 256 threads, as many a SM as shared
// memory allows (at most 4), each walking the lanes b = blockIdx.x,
// + gridDim.x, ...  A lane's A is one contiguous slab.  One thread copies
// it into a ring of three shared-memory stages with a single bulk copy
// (cp.async.bulk, completing on the stage's mbarrier) where the slab is
// 16-byte aligned, else every thread copies elements with cp.async; the
// lane's vectors follow by cp.async.  So two lanes arrive while one is
// reduced.  Measured on the H100 at the padded shape: the bulk copy beat
// 16-byte cp.async by 2-11 points of the bandwidth bound, three stages
// beat two by 1-5 in f32 (two blocks a SM, not three) and tied in f64,
// and steps of two f32 lanes (68.5 KB, as an f64 lane) lost 3-13 points
// in both widths to the extra index arithmetic.
// Fixed order, so a replay or a repeat solve gives the same bits: a row
// (A·x) is reduced by G threads, thread g summing columns g, g+G, ... in
// order with FMAs, then a butterfly of shuffles (G = 4 at m = 56: every
// thread of the block busy, short dependent chains); a column (Aᵀ·y) by
// one thread, summing the rows in order.
// The normal product computes t = Aᵀv into the stage, w = d∘t there, then
// A·w + δv from the same copy of the slab.  The scale and the shift are
// separate roundings (no contraction into an FMA), so it is bitwise the
// launches it replaces: rmv, d * t, mv, + δ * v.
// Lanes larger than one stage stream tiles of P rows x Q columns (P rows
// while a whole row fits, else one row in Q-column pieces): A·x adds each
// column piece into the output row, Aᵀy each row panel into the output
// column, an element always in the hands of the same thread.  The normal
// product of such a lane is two launches: rmv into a scratch t, then mv
// with the scale d and the shift δv.
//
// C interface: one function per element type; it launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a mode, tile or bulk copy it
// does not take.

#include <cuda_pipeline.h>
#include <cstdint>

#include "batchlast.cuh"
#include "batchlast_smem.cuh"

namespace {

constexpr int kLaneMvThreads = 256;
constexpr int kLaneMvStages = 3;

enum LaneMvMode { kModeMv = 0, kModeRmv = 1, kModeNormal = 2 };

// a vector operand: element (b, j) at p[b * sb + j * sj]; p == nullptr
// where the product takes no such vector
template <typename T>
struct LaneVec {
  const T* p;
  int64_t sb, sj;
};

template <typename T>
struct LaneMvArgs {
  const T* A;      // (B, m, n), contiguous
  LaneVec<T> x;    // (n): mv's x
  LaneVec<T> s;    // (n): mv's scale of x; the normal product's d
  LaneVec<T> y;    // (m): rmv's y; the shift's v
  LaneVec<T> reg;  // (B,): the shift δ (sj unused)
  T* out;          // (B, m) or (B, n), contiguous
  int m, n, B, P, Q;
};

__host__ __device__ inline int lanemv_round4(int k) { return (k + 3) & ~3; }

// one ring stage, in elements: the P x Q tile, then x and s (Q each), y
// (P) and reg, each rounded up to 4 elements (the tile stays 16-byte aligned)
__host__ __device__ inline int lanemv_stage_len(int P, int Q) {
  return lanemv_round4(P * Q) + 2 * lanemv_round4(Q) + lanemv_round4(P) + 4;
}

// a block's shared memory: the ring, then one 8-byte mbarrier a stage
__host__ __device__ inline int lanemv_smem_bytes(int P, int Q, int size) {
  return kLaneMvStages * (lanemv_stage_len(P, Q) * size + 8);
}

__device__ __forceinline__ float lanemv_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double lanemv_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float lanemv_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double lanemv_add(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ uint32_t lanemv_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the bulk copy's barrier: one arrival (the issuing thread's, with the
// bytes to expect), completed when the copy has landed
__device__ __forceinline__ void lanemv_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(lanemv_smem_addr(bar)));
}

__device__ __forceinline__ void lanemv_bulk_copy(void* dst, const void* src, uint32_t bytes,
                                                 uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(lanemv_smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(lanemv_smem_addr(dst)), "l"(src), "r"(bytes), "r"(lanemv_smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void lanemv_bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred lanemv_done;\n"
      "lanemv_wait:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 lanemv_done, [%0], %1;\n\t"
      "@!lanemv_done bra lanemv_wait;\n}"
      ::"r"(lanemv_smem_addr(bar)), "r"(parity) : "memory");
}

// where step `step` of this block lies: its lane, rows [r0, r0 + rows)
// and columns [c0, c0 + cols)
template <typename T>
__device__ __forceinline__ void lanemv_tile(const LaneMvArgs<T>& a, int64_t step, int tiles,
                                            int col_tiles, int64_t& b, int& r0, int& rows,
                                            int& c0, int& cols) {
  b = blockIdx.x + (step / tiles) * static_cast<int64_t>(gridDim.x);
  const int t = static_cast<int>(step % tiles);
  r0 = (t / col_tiles) * a.P;
  c0 = (t % col_tiles) * a.Q;
  rows = min(a.P, a.m - r0);
  cols = min(a.Q, a.n - c0);
}

template <typename T>
__device__ __forceinline__ void lanemv_copy_vec(T* dst, const LaneVec<T>& v, int64_t b, int j0,
                                                int len) {
  if (v.p == nullptr) return;
  const T* src = v.p + b * v.sb + j0 * v.sj;
  for (int j = threadIdx.x; j < len; j += kLaneMvThreads)
    __pipeline_memcpy_async(dst + j, src + j * v.sj, sizeof(T));
}

// issue the copies of one step into `stage` and commit the vectors' as one
// group; with BULK the tile is one bulk copy completing on `bar` (whole
// rows, or a row's piece: rows == 1 whenever cols < n)
template <typename T, bool BULK>
__device__ __forceinline__ void lanemv_issue(T* stage, uint64_t* bar, const LaneMvArgs<T>& a,
                                             int64_t b, int r0, int rows, int c0, int cols) {
  const T* src = a.A + (b * a.m + r0) * a.n + c0;
  if (BULK) {
    if (threadIdx.x == 0) lanemv_bulk_copy(stage, src, rows * cols * sizeof(T), bar);
  } else if (cols == a.n) {  // whole rows: the tile is contiguous in A
    for (int i = threadIdx.x; i < rows * cols; i += kLaneMvThreads)
      __pipeline_memcpy_async(stage + i, src + i, sizeof(T));
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kLaneMvThreads) {
      const int r = i / cols;
      __pipeline_memcpy_async(stage + i, src + static_cast<int64_t>(r) * a.n + (i - r * cols),
                              sizeof(T));
    }
  }
  T* xs = stage + lanemv_round4(a.P * a.Q);
  T* ss = xs + lanemv_round4(a.Q);
  T* ys = ss + lanemv_round4(a.Q);
  T* rs = ys + lanemv_round4(a.P);
  lanemv_copy_vec(xs, a.x, b, c0, cols);
  lanemv_copy_vec(ss, a.s, b, c0, cols);
  lanemv_copy_vec(ys, a.y, b, r0, rows);
  if (a.reg.p != nullptr && threadIdx.x == 0)
    __pipeline_memcpy_async(rs, a.reg.p + b * a.reg.sb, sizeof(T));
  __pipeline_commit();
}

// out[b, r0 + i] (+)= Σ_j tile[i, j] w[j] for the tile's rows: G threads a
// row (G the largest power of two up to 32 with G · rows <= 256), thread g
// of a row summing columns g, g + G, ... in order with FMAs, then a
// butterfly of shuffles over the G (each ends with the same sum); the last
// column piece adds the shift δ·v[i] when there is one
template <typename T>
__device__ __forceinline__ void lanemv_rows(const LaneMvArgs<T>& a, const T* tile, const T* w,
                                            const T* ys, const T* rs, int64_t b, int r0,
                                            int rows, int c0, int cols) {
  int G = 32;
  while (G > 1 && G * rows > kLaneMvThreads) G >>= 1;
  const int g = threadIdx.x & (G - 1);
  const bool shift = a.reg.p != nullptr && c0 + cols == a.n;
  for (int base = 0; base < rows; base += kLaneMvThreads / G) {
    const int i = base + static_cast<int>(threadIdx.x) / G;
    T acc = T(0);
    if (i < rows) {
      const T* row = tile + i * cols;
#pragma unroll 4
      for (int j = g; j < cols; j += G) acc = fma(row[j], w[j], acc);
    }
    for (int o = G >> 1; o > 0; o >>= 1)  // every lane of the warp takes part
      acc = lanemv_add(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if (i < rows && g == 0) {
      T* dst = a.out + b * a.m + r0 + i;
      if (c0 != 0) acc = lanemv_add(*dst, acc);
      if (shift) acc = lanemv_add(acc, lanemv_mul(rs[0], ys[i]));
      *dst = acc;
    }
  }
}

template <typename T, bool BULK, int MODE>
__global__ void __launch_bounds__(kLaneMvThreads)
lane_matvec_kernel(const LaneMvArgs<T> a) {
  constexpr int S = kLaneMvStages;
  extern __shared__ __align__(16) unsigned char lanemv_smem[];
  T* ring = reinterpret_cast<T*>(lanemv_smem);
  const int stage_len = lanemv_stage_len(a.P, a.Q);
  // the stages' barriers follow the ring (a stage is a multiple of 16 bytes)
  uint64_t* bars = reinterpret_cast<uint64_t*>(lanemv_smem + S * stage_len * sizeof(T));
  if (BULK) {
    if (threadIdx.x == 0) {
      for (int k = 0; k < S; ++k) lanemv_bar_init(bars + k);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  const int col_tiles = (a.n + a.Q - 1) / a.Q;
  const int tiles = ((a.m + a.P - 1) / a.P) * col_tiles;
  // the host keeps gridDim.x <= B, so every block has a lane
  const int64_t lanes = (a.B - 1 - static_cast<int64_t>(blockIdx.x)) / gridDim.x + 1;
  const int64_t steps = lanes * tiles;
  int64_t b;
  int r0, rows, c0, cols;

#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < steps) {
      lanemv_tile(a, k, tiles, col_tiles, b, r0, rows, c0, cols);
      lanemv_issue<T, BULK>(ring + k * stage_len, bars + k, a, b, r0, rows, c0, cols);
    } else {
      __pipeline_commit();
    }
  }
  for (int64_t step = 0; step < steps; ++step) {
    // the stage of step + S - 1 was freed by the last barrier of step - 1
    const int64_t next = step + S - 1;
    if (next < steps) {
      lanemv_tile(a, next, tiles, col_tiles, b, r0, rows, c0, cols);
      lanemv_issue<T, BULK>(ring + (next % S) * stage_len, bars + next % S, a, b, r0, rows, c0,
                            cols);
    } else {
      __pipeline_commit();  // an empty group keeps the count of pending groups
    }
    __pipeline_wait_prior(S - 1);
    if (BULK) lanemv_bar_wait(bars + step % S, static_cast<uint32_t>((step / S) & 1));
    __syncthreads();

    T* tile = ring + (step % S) * stage_len;
    T* xs = tile + lanemv_round4(a.P * a.Q);
    T* ss = xs + lanemv_round4(a.Q);
    T* ys = ss + lanemv_round4(a.Q);
    T* rs = ys + lanemv_round4(a.P);
    lanemv_tile(a, step, tiles, col_tiles, b, r0, rows, c0, cols);
    if (MODE == kModeMv) {
      if (a.s.p != nullptr) {  // w = s ∘ x, rounded once
        for (int j = threadIdx.x; j < cols; j += kLaneMvThreads) xs[j] = lanemv_mul(ss[j], xs[j]);
        __syncthreads();
      }
      lanemv_rows(a, tile, xs, ys, rs, b, r0, rows, c0, cols);
    } else {
      // columns: t[j] = Σ_i tile[i, j] y[i], one thread a column
      for (int j = threadIdx.x; j < cols; j += kLaneMvThreads) {
        T acc = T(0);
#pragma unroll 4
        for (int i = 0; i < rows; ++i) acc = fma(tile[i * cols + j], ys[i], acc);
        if (MODE == kModeNormal) {
          xs[j] = lanemv_mul(ss[j], acc);  // w = d ∘ Aᵀv, kept in the stage
        } else {
          T* dst = a.out + b * a.n + c0 + j;
          if (r0 != 0) acc = lanemv_add(*dst, acc);
          *dst = acc;
        }
      }
      if (MODE == kModeNormal) {  // one tile holds the lane: A·w + δv
        __syncthreads();
        lanemv_rows(a, tile, xs, ys, rs, b, r0, rows, c0, cols);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool BULK, int MODE>
int launch_lane_matvec_t(const LaneMvArgs<T>& a, int grid, int smem, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(lane_matvec_kernel<T, BULK, MODE>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_matvec_kernel<T, BULK, MODE><<<grid, kLaneMvThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int launch_lane_matvec_mode(const LaneMvArgs<T>& a, int bulk, int grid, int smem,
                            cudaStream_t stream) {
  return bulk ? launch_lane_matvec_t<T, true, MODE>(a, grid, smem, stream)
              : launch_lane_matvec_t<T, false, MODE>(a, grid, smem, stream);
}

template <typename T>
int launch_lane_matvec(int mode, const void* A, const void* x, int64_t sxb, int64_t sxj,
                       const void* s, int64_t ssb, int64_t ssj, const void* y, int64_t syb,
                       int64_t syj, const void* reg, int64_t srb, void* out, int m, int n, int B,
                       int P, int Q, int bulk, int grid, int smem, void* stream) {
  cudaGetLastError();
  constexpr int size = static_cast<int>(sizeof(T));
  const bool whole = P == m && Q == n;
  // a bulk copy moves one 16-byte aligned run: a whole lane, whole rows or a row's piece
  const bool bulk_ok =
      reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
      (whole ? static_cast<int64_t>(m) * n * size % 16 == 0
             : n * size % 16 == 0 && (Q == n || (P == 1 && Q * size % 16 == 0)));
  const bool ok = mode >= kModeMv && mode <= kModeNormal && m > 0 && n > 0 && P > 0 && Q > 0 &&
                  P <= m && Q <= n && grid > 0 && grid <= B && (mode != kModeNormal || whole) &&
                  (!bulk || bulk_ok) && smem >= lanemv_smem_bytes(P, Q, size);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const LaneMvArgs<T> a{static_cast<const T*>(A),
                        {static_cast<const T*>(x), sxb, sxj},
                        {static_cast<const T*>(s), ssb, ssj},
                        {static_cast<const T*>(y), syb, syj},
                        {static_cast<const T*>(reg), srb, 0},
                        static_cast<T*>(out),
                        m, n, B, P, Q};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kModeMv: return launch_lane_matvec_mode<T, kModeMv>(a, bulk, grid, smem, st);
    case kModeRmv: return launch_lane_matvec_mode<T, kModeRmv>(a, bulk, grid, smem, st);
    default: return launch_lane_matvec_mode<T, kModeNormal>(a, bulk, grid, smem, st);
  }
}

}  // namespace

extern "C" {

int pycllp_lane_matvec_f32(int mode, const void* A, const void* x, int64_t sxb, int64_t sxj,
                           const void* s, int64_t ssb, int64_t ssj, const void* y, int64_t syb,
                           int64_t syj, const void* reg, int64_t srb, void* out, int m, int n,
                           int B, int P, int Q, int bulk, int grid, int smem, void* stream) {
  return launch_lane_matvec<float>(mode, A, x, sxb, sxj, s, ssb, ssj, y, syb, syj, reg, srb, out,
                                   m, n, B, P, Q, bulk, grid, smem, stream);
}

int pycllp_lane_matvec_f64(int mode, const void* A, const void* x, int64_t sxb, int64_t sxj,
                           const void* s, int64_t ssb, int64_t ssj, const void* y, int64_t syb,
                           int64_t syj, const void* reg, int64_t srb, void* out, int m, int n,
                           int B, int P, int Q, int bulk, int grid, int smem, void* stream) {
  return launch_lane_matvec<double>(mode, A, x, sxb, sxj, s, ssb, ssj, y, syb, syj, reg, srb,
                                    out, m, n, B, P, Q, bulk, grid, smem, stream);
}

}  // extern "C"
