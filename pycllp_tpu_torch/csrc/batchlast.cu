// Batch-last Cholesky factor and k-RHS solve for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels in pycllp_tpu/ops/batchlast.py:
//   chol_bl  <- _chol_bl  (_chol_kernel -> _chol_body)
//   solve_bl <- _solve_bl (_solve_kernel)
//
// The kernels are the float instantiations of the templates in
// batchlast.cuh, which holds the layout, the design and the semantics.
//
// What bounds them on the H100: memory traffic and latency, not
// arithmetic.  The factor does ~m^3/6 read-modify-writes per lane; a
// 16,384-lane chunk at m = 64 is a 268 MB M, larger than the 50 MB L2,
// so the trailing updates stream through HBM (~5.7 GB per factor).  One
// thread per lane would leave only B threads in flight (~6% of the
// card's thread slots at B = 16,384) and was measured 4.6x slower;
// splitting the rows over 8 warps puts 8x as many loads in flight.  The
// solve reads the lower triangle of L twice (268 MB at B = 16,384) with
// only k * B threads in flight, so it is latency-bound too: its loads of
// L are independent of each other, unrolled 4 deep (the best of 1, 4, 8
// and 16 as measured on the H100; a working vector in shared memory
// measured slower than V in L1).  Keeping M in shared memory (one CTA
// per lane, 16 KB at m = 64) and wgmma/TMA are later work.
//
// C interface: each function launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

#include "batchlast.cuh"

extern "C" {

int pycllp_chol_bl_f32(const void* M, const void* reg, void* L, void* dinv,
                       int m, int B, void* stream) {
  return launch_chol_bl<float>(M, reg, L, dinv, m, B, stream);
}

int pycllp_solve_bl_f32(const void* L, const void* dinv, const void* R, void* V,
                        int m, int B, int k_rhs, void* stream) {
  return launch_solve_bl<float>(L, dinv, R, V, m, B, k_rhs, stream);
}

}  // extern "C"
