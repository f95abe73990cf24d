// Wide-phase kernels for Hopper (sm_90a): native-FP64 factor and solve,
// and the Ozaki slicing pass.
//
// Replaces the Pallas TPU kernels in pycllp_tpu/ops/df64.py:
//   df_chol_bl      <- _df_chol_bl      (_df_chol_kernel)
//   df_solve_bl     <- _df_solve_bl     (_df_solve_kernel)
//   slice_rounds_bl <- _slice_rounds_bl (_slice_rounds_kernel)
//
// df_chol_bl / df_solve_bl.  The reference computes the Cholesky factor
// and the k-RHS solve in double-single arithmetic (hi/lo f32 pairs, ~18
// f32 operations per multiply-add) only because the TPU has no FP64.
// The H100 has native FP64 at half its FP32 rate, so these are the
// double instantiations of the batch-last templates in batchlast.cuh:
// the same function, computed more accurately (a 53-bit unit instead of
// the pair's ~49 bits), with none of the pair arithmetic.  The
// reference's masked full-width product and tree sum in the solve was a
// workaround for Mosaic's compile payload and is not carried over: the
// loops are those of solve_bl.  Semantics kept from _df_chol_kernel: the
// shift reg[b] is added at each pivot read (the caller rounds it to f32
// first, as the reference adds (reg_f32, 0)), a pivot that is not > 0
// or is NaN writes NaN to that diagonal and to dinv and poisons its lane
// only, and only the lower triangle is factored, because the solve reads
// only L[i, :i] and dinv.
//
// What bounds them on this path: latency, at a few % occupancy.  The
// df64 set factors at the drain-tier widths, 1,024 lanes in tier 1 and
// 256 in tier 2, which at 32 lanes per block is only 32 or 8 blocks on
// 132 SMs.  A 1,024-lane f64 M at m = 64 is 33.5 MB, so it fits in the
// 50 MB L2 and the trailing updates mostly hit L2, not HBM.  A design
// for narrow batches (fewer lanes per block, or one block per lane with
// M in shared memory) is later work.
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
// off-TPU path produces, so the f32 group GEMMs stay exact.
//
// C interface: each function launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

#include "batchlast.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
slice_rounds_kernel(const float* __restrict__ Rh, const float* __restrict__ Rl,
                    float* __restrict__ S, int64_t n_elem, int s, int n_slices) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_elem) return;
  float h = Rh[t];
  float l = Rl[t];
  for (int k = 1; k <= n_slices; ++k) {
    const float up = ldexpf(1.0f, s * k);     // exact powers of two
    const float down = ldexpf(1.0f, -s * k);
    const float ik = rintf(__fmul_rn(h, up));  // integer-valued, |ik| <= 2^s
    S[(k - 1) * n_elem + t] = ik;
    // (h, l) := df_sub((h, l), (xk, 0)) = df_add((h, l), (-xk, -0))
    const float b = -__fmul_rn(ik, down);
    // two_sum(h, b)
    const float sum = __fadd_rn(h, b);
    const float bb = __fsub_rn(sum, h);
    const float e = __fadd_rn(__fsub_rn(h, __fsub_rn(sum, bb)), __fsub_rn(b, bb));
    // fast_two_sum(sum, e + (l + -0))
    const float tail = __fadd_rn(e, __fadd_rn(l, -0.0f));
    h = __fadd_rn(sum, tail);
    l = __fsub_rn(tail, __fsub_rn(h, sum));
  }
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

int pycllp_slice_rounds_bl(const void* Rh, const void* Rl, void* S, int r, int B,
                           int s, int n_slices, void* stream) {
  cudaGetLastError();
  const int64_t n_elem = static_cast<int64_t>(r) * B;
  slice_rounds_kernel<<<blocks_for(n_elem), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Rh), static_cast<const float*>(Rl), static_cast<float*>(S),
      n_elem, s, n_slices);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
