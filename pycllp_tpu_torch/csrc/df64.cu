// Wide-phase kernels for Hopper (sm_90a): native-FP64 factor and solve,
// the Ozaki slicing pass and the fused Ozaki product.
//
// Replaces the Pallas TPU kernels in pycllp_tpu/ops/df64.py:
//   df_chol_bl       <- _df_chol_bl      (_df_chol_kernel)
//   df_solve_bl      <- _df_solve_bl     (_df_solve_kernel)
//   ozaki_product_bl <- _slice_rounds_bl (_slice_rounds_kernel) with the
//                       group GEMMs of _ozaki_matmul (ozaki.cuh); its
//                       formation entry, ozaki_formation_bl, computes M's
//                       triangle and stores each row twice
//   slice_rounds_bl  <- _slice_rounds_bl, the slicing pass alone
//
// df_chol_bl / df_solve_bl.  The reference computes the Cholesky factor
// and the k-RHS solve in double-single arithmetic (hi/lo f32 pairs, ~18
// f32 operations per multiply-add) only because the TPU has no FP64.
// The H100 has native FP64 at half its FP32 rate, so these are the
// double instantiations of the batch-last templates (batchlast_smem.cuh,
// and batchlast.cuh for large m): the same function, computed more
// accurately (a 53-bit unit instead of the pair's ~49 bits), with none of
// the pair arithmetic.  The reference's masked full-width product and tree
// sum in the solve was a workaround for Mosaic's compile payload and is
// not carried over: the loops are those of solve_bl.  Semantics kept from
// _df_chol_kernel: the shift reg[b] is added at each pivot read (the
// caller rounds it to f32 first, as the reference adds (reg_f32, 0)), a
// pivot that is not > 0 or is NaN writes NaN to that diagonal and to dinv
// and poisons its lane only, and only the lower triangle is factored,
// because the solve reads only L[i, :i] and dinv.
//
// The df64 set factors at the drain-tier widths, 1,024 lanes in tier 1
// and 256 in tier 2.  The streaming kernels of batchlast.cuh ran there at
// a few % occupancy: 32 lanes per factor block is 32 or 8 blocks on 132
// SMs, and the one-thread-per-(lane, RHS) solve is 8 or 2 blocks of 128
// threads.  So the default route is the lane-group design of
// batchlast_smem.cuh in double: each lane's triangle (16,640 B at m = 64)
// in shared memory, a warp a lane, G lanes a block with G chosen on the
// host so that the tier widths put a block on every SM (G = 4 at B =
// 1,024, G = 1 at 256).  A 1,024-lane f64 factor reads and writes 34.6 MB
// (0.010 ms of HBM); its ~89 MFLOP of FP64 are not the bound.  The
// streaming kernels remain for m > 240, whose one-lane triangle does not
// fit in shared memory.
//
// slice_rounds_bl.  Cuts a normalised operand, given as an f32 (hi, lo)
// pair, into n_slices integer-valued s-bit bands for the exact group
// GEMMs of the Ozaki product: slice k is rint(h * 2^(s*k)), and the
// remainder (h, l) -= slice_k * 2^(-s*k) is carried in double-single.
// One thread per element keeps the remainder in registers: one read of
// the pair and one f32 write per slice, the point of the TPU kernel.
// It is bound by HBM bytes: (8 + 4 * n_slices) per element.  It must be
// bit-identical to the plain version (torch.round, then df_sub in f32
// tensor ops), so it rounds half to even (rintf), and the two-sum is
// written with __fadd_rn / __fsub_rn / __fmul_rn, which nvcc does not
// contract into FMAs; the build uses no fast-math flag, so denormals
// are kept.  The slices are f32 (integers <= 2^s), as the reference's
// off-TPU path produces, so the f32 group GEMMs stay exact.  Its round is
// ozaki_slice_round (ozaki.cuh), which ozaki_product_bl runs too.  Since
// every shared-A Ozaki product became one ozaki_product_bl launch, this
// pass runs on no solver path: it is the split route (slicing pass, then
// torch.matmul and the f64 sum) that the product is held to bitwise.
//
// C interface: each function launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

#include "batchlast.cuh"
#include "batchlast_smem.cuh"
#include "ozaki.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
slice_rounds_kernel(const float* __restrict__ Rh, const float* __restrict__ Rl,
                    float* __restrict__ S, int64_t n_elem, int s, int n_slices) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_elem) return;
  float h = Rh[t];
  float l = Rl[t];
  for (int k = 1; k <= n_slices; ++k) S[(k - 1) * n_elem + t] = ozaki_slice_round(h, l, s, k);
}

}  // namespace

extern "C" {

int pycllp_chol_bl_f64(const void* M, const void* reg, void* L, void* dinv,
                       int m, int B, void* stream) {
  return launch_chol_bl<double>(M, reg, L, dinv, m, B, stream);
}

int pycllp_solve_bl_f64(const void* L, const void* dinv, const void* R, void* V,
                        int m, int B, int k_rhs, void* stream) {
  return launch_solve_bl<double>(L, dinv, R, V, m, B, k_rhs, stream);
}

int pycllp_chol_bl_smem_f64(const void* M, const void* reg, void* L, void* dinv,
                            int m, int B, int G, void* stream) {
  return launch_chol_bl_smem<double>(M, reg, L, dinv, m, B, G, stream);
}

int pycllp_solve_bl_smem_f64(const void* L, const void* dinv, const void* R, void* V,
                             int m, int B, int k_rhs, int G, void* stream) {
  return launch_solve_bl_smem<double>(L, dinv, R, V, m, B, k_rhs, G, stream);
}

int pycllp_slice_rounds_bl(const void* Rh, const void* Rl, void* S, int r, int B,
                           int s, int n_slices, void* stream) {
  cudaGetLastError();
  const int64_t n_elem = static_cast<int64_t>(r) * B;
  slice_rounds_kernel<<<blocks_for(n_elem), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Rh), static_cast<const float*>(Rl), static_cast<float*>(S),
      n_elem, s, n_slices);
  return static_cast<int>(cudaGetLastError());
}

int pycllp_ozaki_product_bl(const void* Wp, const void* We, const void* d, void* out, int rows,
                            int n, int B, int sdb, int sdj, int s, int n_slices, int cut,
                            void* stream) {
  cudaGetLastError();
  return static_cast<int>(launch_ozaki_product(Wp, We, d, out, rows, n, B, sdb, sdj, s, n_slices,
                                               cut, nullptr, static_cast<cudaStream_t>(stream)));
}

// the normal-matrix formation on M's triangle: Wp and We hold the rows
// (a, b), a <= b, of W = A o A, dst each one's two rows of the (m*m, B) out
int pycllp_ozaki_formation_bl(const void* Wp, const void* We, const void* dst, const void* d,
                              void* out, int rows, int n, int B, int sdb, int sdj, int s,
                              int n_slices, int cut, void* stream) {
  cudaGetLastError();
  return static_cast<int>(launch_ozaki_product(Wp, We, d, out, rows, n, B, sdb, sdj, s, n_slices,
                                               cut, dst, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
