// The Ozaki-scheme product for Hopper (sm_90a): the slicing round that
// slice_rounds_kernel (csrc/df64.cu) runs too, and ozaki_product_bl, the
// whole exact product out = W @ d^T of one _ozaki_matmul in one launch.
//
// Replaces the Pallas TPU kernel _slice_rounds_bl (_slice_rounds_kernel,
// pycllp_tpu/ops/df64.py) together with the host loop of _ozaki_matmul
// around it: the per-lane normalisation, the slicing, the cut - 1 group
// GEMMs (bf16 on the TPU's MXU with an f32 accumulator, _gemm_dtype) and
// their f64 combination.  On the card that route was ~50 launches a
// matvec and ~70 a normal-matrix formation, with the slices written to
// device memory, read back and concatenated once per level.
//
// What it computes (ops/df64.py, _ozaki_matmul_plain, bit for bit):
//   out[r, b] = (sum over t = 2 .. cut, in that order, in f64, of
//                G_t[r, b] * 2^(-s*t)) * (We[r] * de[b])
//   G_t[r, b] = sum over pairs (k, l = t - k) and j of Ws_k[r, j] * ds_l[b, j]
// where Ws_k are W's integer slices (prepared once per A, packed as bf16
// in the mma A-fragment order, see below) and ds_l the slices of lane b
// of d, normalised per lane in f64 as _df_slice_int does: mx = max_j
// |d[b, j]| (NaN sticky), clamped at FLT_MIN; E = ceil(log2(mx)); R =
// d * exp2(-E); hi = (float) R, lo = (float) (R - hi); de = exp2(E).
//
// Why it is exact.  A slice is an integer in [-2^s, 2^s] with s <= 7, so
// bf16 holds it exactly, and every product of two is exact.  ozaki_params
// picks s so that any partial sum of a level stays <= 2^24, so the f32
// accumulator of mma.sync holds every partial sum exactly, in whatever
// order the tensor core adds.  Each G_t is then the same integer that
// the split route's f32 GEMM gives, and the f64 combination runs the same
// operations in the same order with __dmul_rn / __dadd_rn (nvcc contracts
// nothing into an FMA), so the result is bitwise that of the split route.
//
// Design.  Grid (ceil(B / 32), rows_pad / (16 * MT)); a block of four
// warps owns 16 * MT rows and 32 lanes, a warp 8 lanes (one mma n-tile)
// and MT m-tiles of 16 rows.  Each thread first reduces |d| over j for its
// lane (the B-fragment lane, groupID), four threads a lane and a shuffle.
// Then, per 16-wide step of the contraction, each thread slices the four
// d values its B fragment holds, (lane, j0 + 2q + {0, 1, 8, 9}), straight
// from device memory (L1/L2), into every slice l <= L = min(n_slices,
// cut - 1), packs them as bf16 pairs in registers (the slices never reach
// device or shared memory), then for each W slice k loads its A fragment
// (16 bytes a thread, coalesced: 512 contiguous bytes a warp) and issues
// one mma.m16n8k16 bf16 -> f32 per pair (k, l) with k + l <= cut into the
// level accumulator acc[k + l - 2].  All cut - 1 level accumulators stay
// in registers; the levels are a template bound (MAXL), so every index is
// a compile-time constant.  The epilogue combines the levels in f64 and
// scales; the four warps share each A fragment through L1.  Work per
// launch: pairs * 2 * rows * n * B tensor-core operations (the bound at
// the formation's widths), and each row tile of a block re-slices its 32
// lanes' d (n * L rounds a lane, ~12 f32 operations a round).  Padding:
// W's rows to 32 and its contraction to 16 with zeros in the packing, d's
// contraction and lanes with zeros here; a zero adds an exact 0.
//
// Packed W (ops/df64.py, _pack_slices): bf16, shape (rows_pad / 16,
// n_slices, n_pad / 16, 32, 8): for each 16-row tile, slice k and
// 16-column step, the 32 lanes' A fragments of mma.m16n8k16 (row-major
// A), lane = 4 * groupID + q holding rows (g, g + 8) and columns (2q,
// 2q + 1, 2q + 8, 2q + 9) in the register order a0 .. a7.
//
// The formation on M's triangle (MIRROR).  The normal matrix M = A diag(d)
// A^T is formed as W @ d^T with W = A o A, whose rows i*m + j and j*m + i
// are equal bit for bit (IEEE multiplication commutes).  Each output row
// depends on its own row of W alone: its scale We[r], its slices and its
// level sums, which are exact integers whatever the order of addition.
// So DoubleSingleKernels.prepare packs only the m(m+1)/2 rows with i <= j,
// and the MIRROR instantiation stores each computed row r at both rows
// dst[r] = (i*m + j, j*m + i) of the full (m*m, B) output, once on the
// diagonal: every element of M, bitwise the product over all m*m rows,
// for half its row tiles.  Everything before the store is the same code;
// the instantiations without MIRROR (every matvec) are the kernel as it
// was, with dst unused.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One slicing round k of a normalised remainder (h, l), as
// _slice_rounds_bl_plain computes it: slice k = rint(h * 2^(s*k)) (half to
// even), then (h, l) := df_sub((h, l), (slice * 2^(-s*k), 0)) with the
// two-sum written in __f*_rn operations, which nvcc does not contract
// into FMAs.  Every slice of slice_rounds_bl and of ozaki_product_bl is
// this sequence.
__device__ __forceinline__ float ozaki_slice_round(float& h, float& l, int s, int k) {
  // 2^(s*k) and 2^(-s*k) from their exponent bits: exact, since the
  // wrappers keep s * (n_slices + 1) < 126, inside f32's normal range
  const float up = __int_as_float((127 + s * k) << 23);
  const float down = __int_as_float((127 - s * k) << 23);
  const float ik = rintf(__fmul_rn(h, up));  // integer-valued, |ik| <= 2^s
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
  return ik;
}

constexpr int kOzWarps = 4;              // warps a block, side by side along the lanes
constexpr int kOzLanes = 8 * kOzWarps;   // lanes a block: one mma n-tile a warp
constexpr int kOzRowPad = 32;            // packed W's rows are padded to this
constexpr int kOzMaxLevels = 24;         // cut - 1 of the largest instantiation

// |d| maximum that keeps a NaN once it has seen one, as torch.amax does
__device__ __forceinline__ double nan_max(double m, double v) {
  return (isnan(v) || v > m) ? v : m;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  // integers <= 2^7 in magnitude: the conversion is exact (NaN stays NaN)
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// c += a (16x16, row) * b (16x8, col): bf16 inputs, f32 accumulator
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint4& a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// (hi, lo) f32 pair of one normalised d value, as _split_hi_lo
__device__ __forceinline__ void ozaki_split(double x, double scale, float& h, float& l) {
  const double R = __dmul_rn(x, scale);  // exact: a power-of-two scaling
  h = __double2float_rn(R);
  l = __double2float_rn(__dsub_rn(R, static_cast<double>(h)));
}

template <int MAXL, int MT, bool MIRROR>
__global__ void __launch_bounds__(32 * kOzWarps)
ozaki_product_kernel(const uint4* __restrict__ Wp, const double* __restrict__ We,
                     const double* __restrict__ d, double* __restrict__ out, int rows, int n,
                     int B, int64_t sdb, int64_t sdj, int s, int n_slices, int cut,
                     const int2* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // groupID: the B-fragment lane and the C-fragment row
  const int q = lane & 3;   // thread in group
  const int b = blockIdx.x * kOzLanes + warp * 8 + g;
  const bool live = b < B;
  const double* db = d + (live ? static_cast<int64_t>(b) * sdb : 0);
  const int JS = (n + 15) >> 4;
  const int L = min(n_slices, cut - 1);

  // per-lane normalisation in f64 (_df_slice_int): four threads a lane
  double mx = 0.0;
  if (live) {
    for (int j = q; j < n; j += 4) mx = nan_max(mx, fabs(db[j * sdj]));
  }
  mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  if (!isnan(mx)) mx = fmax(mx, 0x1p-126);  // clamp(min=FLT_MIN), NaN kept
  const double E = ceil(log2(mx));
  const double scale = exp2(-E);
  const double de = exp2(E);

  float acc[MAXL][MT][4];
#pragma unroll
  for (int t = 0; t < MAXL; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][mt][i] = 0.0f;

  const uint4* Wblk = Wp + static_cast<int64_t>(blockIdx.y) * MT * n_slices * JS * 32 + lane;
  for (int js = 0; js < JS; ++js) {
    // the B fragments of every slice: (k = 2q, 2q + 1) and (2q + 8, 2q + 9)
    uint32_t bf[MAXL][2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = js * 16 + 2 * q + 8 * half;
      const double x0 = (live && j < n) ? db[j * sdj] : 0.0;
      const double x1 = (live && j + 1 < n) ? db[(j + 1) * sdj] : 0.0;
      float h0, l0, h1, l1;
      ozaki_split(x0, scale, h0, l0);
      ozaki_split(x1, scale, h1, l1);
#pragma unroll
      for (int k = 1; k <= MAXL; ++k) {
        if (k <= L) {
          const float s0 = ozaki_slice_round(h0, l0, s, k);
          const float s1 = ozaki_slice_round(h1, l1, s, k);
          bf[k - 1][half] = bf16x2(s0, s1);
        }
      }
    }
#pragma unroll
    for (int k = 1; k <= MAXL; ++k) {
      if (k > L) break;
      uint4 a[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        a[mt] = __ldg(Wblk + ((static_cast<int64_t>(mt) * n_slices + (k - 1)) * JS + js) * 32);
#pragma unroll
      for (int l = 1; l <= MAXL + 1 - k; ++l) {
        if (l <= L && k + l <= cut) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_bf16_16816(acc[k + l - 2][mt], a[mt], bf[l - 1][0], bf[l - 1][1]);
        }
      }
    }
  }

  // epilogue: the C fragment holds rows (g, g + 8) of each m-tile and lanes
  // (2q, 2q + 1) of the warp's 8; their de live with threads 8q and 8q + 4
  const double de0 = __shfl_sync(0xffffffffu, de, 8 * q);
  const double de1 = __shfl_sync(0xffffffffu, de, 8 * q + 4);
  const int bc = blockIdx.x * kOzLanes + warp * 8 + 2 * q;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (blockIdx.y * MT + mt) * 16 + g + (i >= 2 ? 8 : 0);
      const int bo = bc + (i & 1);
      if (r >= rows || bo >= B) continue;
      double sum = __dmul_rn(static_cast<double>(acc[0][mt][i]), ldexp(1.0, -2 * s));
#pragma unroll
      for (int t = 3; t <= MAXL + 1; ++t) {
        if (t <= cut)
          sum = __dadd_rn(sum, __dmul_rn(static_cast<double>(acc[t - 2][mt][i]),
                                         ldexp(1.0, -s * t)));
      }
      const double v = __dmul_rn(sum, __dmul_rn(We[r], (i & 1) ? de1 : de0));
      if constexpr (MIRROR) {
        const int2 to = dst[r];  // rows (a*m + b, b*m + a) of the pair a <= b
        out[static_cast<int64_t>(to.x) * B + bo] = v;
        if (to.y != to.x) out[static_cast<int64_t>(to.y) * B + bo] = v;
      } else {
        out[static_cast<int64_t>(r) * B + bo] = v;
      }
    }
  }
}

// dst null: out = W @ d^T, (rows, B); else the formation on M's triangle,
// each row r stored at rows dst[r] of the (m*m, B) output (MIRROR)
template <int MAXL, int MT>
cudaError_t launch_ozaki_product_t(const void* Wp, const void* We, const void* d, void* out,
                                   int rows, int n, int B, int64_t sdb, int64_t sdj, int s,
                                   int n_slices, int cut, const void* dst, cudaStream_t stream) {
  const int rows_pad = (rows + kOzRowPad - 1) / kOzRowPad * kOzRowPad;
  const dim3 grid((B + kOzLanes - 1) / kOzLanes, rows_pad / (16 * MT));
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  const auto* Wp_ = static_cast<const uint4*>(Wp);
  const auto* We_ = static_cast<const double*>(We);
  const auto* d_ = static_cast<const double*>(d);
  auto* out_ = static_cast<double*>(out);
  const auto* dst_ = static_cast<const int2*>(dst);
  if (dst_ == nullptr)
    ozaki_product_kernel<MAXL, MT, false><<<grid, 32 * kOzWarps, 0, stream>>>(
        Wp_, We_, d_, out_, rows, n, B, sdb, sdj, s, n_slices, cut, dst_);
  else
    ozaki_product_kernel<MAXL, MT, true><<<grid, 32 * kOzWarps, 0, stream>>>(
        Wp_, We_, d_, out_, rows, n, B, sdb, sdj, s, n_slices, cut, dst_);
  return cudaGetLastError();
}

// The instantiation that holds cut - 1 levels: two m-tiles a warp up to 12
// levels (the matvecs' 7-8, the formation's 10-11), one beyond, which keeps
// the level accumulators within the register file.
cudaError_t launch_ozaki_product(const void* Wp, const void* We, const void* d, void* out,
                                 int rows, int n, int B, int64_t sdb, int64_t sdj, int s,
                                 int n_slices, int cut, const void* dst, cudaStream_t stream) {
  const int levels = cut - 1;
  if (levels < 1 || levels > kOzMaxLevels || n_slices < 1 || s < 1) return cudaErrorInvalidValue;
  if (levels <= 8)
    return launch_ozaki_product_t<8, 2>(Wp, We, d, out, rows, n, B, sdb, sdj, s, n_slices, cut,
                                        dst, stream);
  if (levels <= 12)
    return launch_ozaki_product_t<12, 2>(Wp, We, d, out, rows, n, B, sdb, sdj, s, n_slices, cut,
                                         dst, stream);
  if (levels <= 16)
    return launch_ozaki_product_t<16, 1>(Wp, We, d, out, rows, n, B, sdb, sdj, s, n_slices, cut,
                                         dst, stream);
  return launch_ozaki_product_t<24, 1>(Wp, We, d, out, rows, n, B, sdb, sdj, s, n_slices, cut,
                                       dst, stream);
}

}  // namespace
