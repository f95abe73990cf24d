// Batch-last Cholesky factor and k-RHS solve for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels in pycllp_tpu/ops/batchlast.py:
//   chol_bl         <- _chol_bl         (_chol_kernel -> _chol_body)
//   solve_bl        <- _solve_bl        (_solve_kernel)
//   fused_factor_bl <- _fused_factor_bl (_fused_factor_kernel -> _chol_body)
//   facsol_bl       <- _facsol_bl       (_facsol_kernel)
//
// Each is the float instantiation of two designs:
// * the lane-group kernels of batchlast_smem.cuh (chol_bl_smem,
//   solve_bl_smem, facsol_bl_smem, fused_factor_bl_smem), which keep each
//   lane's triangle in shared memory and factor it with one routine
//   (lane_factor): the default at every m whose one-lane triangle fits
//   (m <= 340 in float; m <= 128 for fused_factor_bl); the source note there
//   says what bounds them and what the design does about it;
// * the streaming kernels of batchlast.cuh (chol_bl_kernel,
//   solve_bl_kernel) and of this file (fused_factor_bl_kernel,
//   facsol_bl_kernel), which hold the triangle in device memory, for the
//   larger m.  The streaming factor does ~m^3/6 read-modify-writes per
//   lane in device memory (~5.7 GB per factor at m = 64, B = 16,384) with
//   its rows split over 8 warps; the streaming solve runs one thread per
//   (lane, right-hand side) and reads L twice.  The two streaming fused
//   kernels below run that factor's pivot loop (chol_pivots).
// The host chooses between them by shape alone (ops/batchlast.py).
//
// The streaming fused kernels, for the larger m (m > 128 for
// fused_factor_bl, m > 340 for facsol_bl) and stream_ms:
//
// fused_factor_bl(W, dT, reg) -> (L, dinv).  W is (m*m, n) with
// W[i*m + j, q] = A[i, q] * A[j, q], dT is (n, B).  The kernel forms
// M[i, j, b] = sum_q W[i*m + j, q] * dT[q, b] in its own body, straight
// into L, and factors M + reg*I: M never exists as a separate tensor, so
// the split path's write and re-read of M (268 MB each way at m = 64,
// B = 16,384) is gone.  The block layout is chol_bl's (32 lanes x 8
// warps, rows owned by warp i mod 8).  The block stages its (n x 32)
// slice of dT in shared memory (16 KB at n = 128; the bank is the lane,
// so no conflicts), tiled over n in steps of at most kFormMaxTile rows so
// shared memory stays bounded for any n (L accumulates across tiles).
// Each owner warp forms only its rows' lower triangle, kFormRows entries
// at a time: the warp stages those W rows, kFormChunk columns at a time,
// in its own shared-memory tile, and every thread then reads the same W
// address (a broadcast) beside its own lane's dT value.  The upper
// triangle is written as zeros by the kernel (nothing reads it).  What
// bounds the formation: m(m+1)/2 * n FMAs per lane, ~266K at m = 64,
// n = 128, ~4.4 G FMAs for a 16,384-lane chunk, against the split
// path's 268 MB write and re-read of M; the pivot loop that follows is
// the streaming factor's (chol_pivots).
//
// facsol_bl(M, reg, R) -> (L, dinv, V).  The factor and the k-RHS solve
// in one launch.  M is factored IN PLACE (L is M's storage; the
// reference aliases M to L through input_output_aliases), which saves the
// copy of M into a new L; M is a temporary of factor_and_solve.  The
// block keeps its V tile (k x m x 32 floats, 16 KB at k = 2, m = 64) in
// shared memory through both passes and writes V once at the end.  The
// forward substitution rides the pivot loop: at pivot k the owner of row
// k scales w_k = V[:, k] * inv, and after the barrier every owner applies
// V[:, i] -= L[i, k] * w_k to its rows, with column k read from shared
// memory.  The backward pass is right-looking over the rows of L, as in
// _facsol_kernel: for i = m-1 .. 0, v_i = w_i * dinv[i] and each warp
// applies V[:, j] -= L[i, j] * v_i to its rows j < i, one barrier per i.
// The shared tile keeps w_i until the final write, which stores
// w_i * dinv[i], the same product the backward pass used.  A pivot <= 0
// NaNs that lane's diagonal, dinv and V, and no other lane.  It is bound
// as the streaming factor is; what it saves is the streaming solve's
// re-read of L for the forward pass and one launch.
//
// C interface: each function launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

#include "batchlast.cuh"
#include "batchlast_smem.cuh"

namespace {

constexpr int kFormRows = 4;       // fused_factor_bl: M entries a thread forms at once
constexpr int kFormChunk = 32;     // fused_factor_bl: W columns a warp stages at once
constexpr int kFormMaxTile = 256;  // fused_factor_bl: dT rows the block stages at once
static_assert(kFormRows == 4, "the staged W tile is read as float4");

__global__ void __launch_bounds__(kCholLanes * kCholRowWarps)
fused_factor_bl_kernel(const float* __restrict__ W, const float* __restrict__ dT,
                       const float* __restrict__ reg, float* __restrict__ L,
                       float* __restrict__ dinv, int m, int n, int B, int n_tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* col = reinterpret_cast<float*>(smem_raw);  // (m, 32): column k, scaled
  float* dts = col + m * kCholLanes;                // (n_tile, 32): a tile of dT
  const BlockLanes t = block_lanes(B);
  // this warp's W tile: kFormChunk columns x kFormRows rows, column-major
  float4* ws = reinterpret_cast<float4*>(dts + n_tile * kCholLanes) + t.w * kFormChunk;
  const size_t sB = static_cast<size_t>(B);
  const size_t sm = static_cast<size_t>(m);
  const size_t sn = static_cast<size_t>(n);

  for (int n0 = 0; n0 < n; n0 += n_tile) {
    const int nt = min(n_tile, n - n0);
    __syncthreads();  // every warp is done with the previous dT tile
    for (int q = t.w; q < nt; q += kCholRowWarps) {
      dts[q * kCholLanes + t.lane] = t.live ? dT[(n0 + q) * sB + t.b] : 0.0f;
    }
    __syncthreads();
    for (int i = t.w; i < m; i += kCholRowWarps) {
      for (int j0 = 0; j0 <= i; j0 += kFormRows) {
        float acc[kFormRows] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int c0 = 0; c0 < nt; c0 += kFormChunk) {
          const int cn = min(kFormChunk, nt - c0);
          // stage W[i*m + j0 + r, n0 + c0 + lane]: each row one coalesced read
          float v[kFormRows];
#pragma unroll
          for (int r = 0; r < kFormRows; ++r) {
            const int j = j0 + r;
            v[r] = (j <= i && t.lane < cn) ? W[(i * sm + j) * sn + n0 + c0 + t.lane] : 0.0f;
          }
          ws[t.lane] = make_float4(v[0], v[1], v[2], v[3]);
          __syncwarp();
          for (int q = 0; q < cn; ++q) {
            const float d = dts[(c0 + q) * kCholLanes + t.lane];
            const float4 wq = ws[q];  // one address for the whole warp: a broadcast
            acc[0] = fmaf(wq.x, d, acc[0]);
            acc[1] = fmaf(wq.y, d, acc[1]);
            acc[2] = fmaf(wq.z, d, acc[2]);
            acc[3] = fmaf(wq.w, d, acc[3]);
          }
          __syncwarp();  // the tile is read before the next chunk overwrites it
        }
        if (t.live) {
#pragma unroll
          for (int r = 0; r < kFormRows; ++r) {
            const int j = j0 + r;
            if (j <= i) {
              float* p = L + (i * sm + j) * sB + t.b;
              *p = n0 == 0 ? acc[r] : *p + acc[r];
            }
          }
        }
      }
      if (t.live && n0 == 0) {
        for (int j = i + 1; j < m; ++j) L[(i * sm + j) * sB + t.b] = 0.0f;
      }
    }
  }
  __syncthreads();  // M's lower triangle is complete

  NoPivotHook hook;
  chol_pivots(L, dinv, col, t.live ? reg[t.b] : 0.0f, t, m, B, hook);
}

// The forward substitution of facsol_bl, riding chol_pivots' sweep.
struct FacsolHook {
  float* vs;  // (k_rhs, m, 32): the block's right-hand sides, then w, then v
  float* ds;  // (m, 32): dinv, kept for the backward pass
  int m;
  int k_rhs;
  BlockLanes t;

  // before the barrier: the owner of row k (the warp that updated V[:, k]
  // last) scales w_k = V[:, k] * inv
  __device__ __forceinline__ void pivot(int k, float inv) const {
    if (t.w != k % kCholRowWarps) return;
    ds[k * kCholLanes + t.lane] = inv;
    for (int r = 0; r < k_rhs; ++r) vs[(r * m + k) * kCholLanes + t.lane] *= inv;
  }

  // after it: V[:, i] -= L[i, k] * w_k on the owned rows i > k
  __device__ __forceinline__ void update(int k, int first, const float* col) const {
    for (int r = 0; r < k_rhs; ++r) {
      float* vr = vs + r * m * kCholLanes + t.lane;
      const float wk = vr[k * kCholLanes];
      for (int i = first; i < m; i += kCholRowWarps) {
        vr[i * kCholLanes] -= col[i * kCholLanes + t.lane] * wk;
      }
    }
  }
};

__global__ void __launch_bounds__(kCholLanes * kCholRowWarps)
facsol_bl_kernel(float* __restrict__ L, const float* __restrict__ reg,
                 const float* __restrict__ R, float* __restrict__ dinv,
                 float* __restrict__ V, int m, int B, int k_rhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* col = reinterpret_cast<float*>(smem_raw);  // (m, 32): column k, scaled
  float* ds = col + m * kCholLanes;                 // (m, 32): dinv
  float* vs = ds + m * kCholLanes;                  // (k_rhs, m, 32): the V tile
  const BlockLanes t = block_lanes(B);
  const size_t sB = static_cast<size_t>(B);
  const size_t sm = static_cast<size_t>(m);

  // each warp loads its own rows of R; no other warp reads them before
  // the first barrier of the pivot loop
  for (int i = t.w; i < m; i += kCholRowWarps) {
    for (int r = 0; r < k_rhs; ++r) {
      vs[(r * m + i) * kCholLanes + t.lane] = t.live ? R[(r * sm + i) * sB + t.b] : 0.0f;
    }
  }

  FacsolHook hook{vs, ds, m, k_rhs, t};
  chol_pivots(L, dinv, col, t.live ? reg[t.b] : 0.0f, t, m, B, hook);

  // backward, right-looking: v_i = w_i * dinv[i]; w[:i] -= L[i, :i] * v_i
  for (int i = m - 1; i > 0; --i) {
    const float di = ds[i * kCholLanes + t.lane];
    if (t.live) {
      const float* Li = L + i * sm * sB + t.b;
      for (int j = t.w; j < i; j += kCholRowWarps) {
        const float lij = Li[j * sB];
        for (int r = 0; r < k_rhs; ++r) {
          float* vr = vs + r * m * kCholLanes + t.lane;
          vr[j * kCholLanes] -= lij * (vr[i * kCholLanes] * di);
        }
      }
    }
    __syncthreads();  // row i - 1 is final before any warp reads it
  }
  if (t.live) {
    for (int i = t.w; i < m; i += kCholRowWarps) {
      const float di = ds[i * kCholLanes + t.lane];
      for (int r = 0; r < k_rhs; ++r) {
        V[(r * sm + i) * sB + t.b] = vs[(r * m + i) * kCholLanes + t.lane] * di;
      }
    }
  }
}

unsigned int lane_blocks(int B) {
  return static_cast<unsigned int>((B + kCholLanes - 1) / kCholLanes);
}

}  // namespace

extern "C" {

int pycllp_chol_bl_f32(const void* M, const void* reg, void* L, void* dinv,
                       int m, int B, void* stream) {
  return launch_chol_bl<float>(M, reg, L, dinv, m, B, stream);
}

int pycllp_solve_bl_f32(const void* L, const void* dinv, const void* R, void* V,
                        int m, int B, int k_rhs, void* stream) {
  return launch_solve_bl<float>(L, dinv, R, V, m, B, k_rhs, stream);
}

int pycllp_chol_bl_smem_f32(const void* M, const void* reg, void* L, void* dinv,
                            int m, int B, int G, void* stream) {
  return launch_chol_bl_smem<float>(M, reg, L, dinv, m, B, G, stream);
}

int pycllp_solve_bl_smem_f32(const void* L, const void* dinv, const void* R, void* V,
                             int m, int B, int k_rhs, int G, void* stream) {
  return launch_solve_bl_smem<float>(L, dinv, R, V, m, B, k_rhs, G, stream);
}

int pycllp_fused_factor_bl_f32(const void* W, const void* dT, const void* reg, void* L,
                               void* dinv, int m, int n, int B, void* stream) {
  cudaGetLastError();
  const int n_tile = n < kFormMaxTile ? n : kFormMaxTile;
  const size_t smem = (static_cast<size_t>(m) + n_tile) * kCholLanes * sizeof(float) +
                      kCholRowWarps * kFormChunk * sizeof(float4);
  const cudaError_t err = allow_smem(fused_factor_bl_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_factor_bl_kernel<<<lane_blocks(B), dim3(kCholLanes, kCholRowWarps), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(dT),
      static_cast<const float*>(reg), static_cast<float*>(L), static_cast<float*>(dinv),
      m, n, B, n_tile);
  return static_cast<int>(cudaGetLastError());
}

// Wp: W's lower-triangle rows, packed and transposed, (n, m(m+1)/2)
int pycllp_fused_factor_bl_smem_f32(const void* Wp, const void* dT, const void* reg, void* L,
                                    void* dinv, int m, int n, int B, int G, void* stream) {
  return launch_fused_factor_bl_smem<float>(Wp, dT, reg, L, dinv, m, n, B, G, stream);
}

int pycllp_facsol_bl_smem_f32(void* L, const void* reg, const void* R, void* dinv, void* V,
                              int m, int B, int k_rhs, int G, void* stream) {
  return launch_facsol_bl_smem<float>(L, reg, R, dinv, V, m, B, k_rhs, G, stream);
}

int pycllp_facsol_bl_f32(void* L, const void* reg, const void* R, void* dinv, void* V,
                         int m, int B, int k_rhs, void* stream) {
  cudaGetLastError();
  const size_t smem = static_cast<size_t>(2 + k_rhs) * m * kCholLanes * sizeof(float);
  const cudaError_t err = allow_smem(facsol_bl_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  facsol_bl_kernel<<<lane_blocks(B), dim3(kCholLanes, kCholRowWarps), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(L), static_cast<const float*>(reg), static_cast<const float*>(R),
      static_cast<float*>(dinv), static_cast<float*>(V), m, B, k_rhs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
