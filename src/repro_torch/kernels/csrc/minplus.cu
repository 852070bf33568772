// The min-plus product of the single-path closures, by hand for Hopper
// (sm_90a): the sparse-row design of sparse_rows.cuh on the (min, +)
// semiring, with the rhs rows gathered inside the kernel through a slab and
// a row index.
//
// Replaces no TPU kernel: the reference computes the product in plain jnp
// (repro/core/semantics.py:50, _minplus), and the port's plain version is
// repro_torch/kernels/ref.py::minplus_ref.  It computes
//
//   out[p, i, j] = min(acc[p, i, j] (inf without acc),
//                      min over k of lhs[p, i, k] + base[s, r, j])
//   with s = slab[p] (p without a slab index), r = row[k] (k without one)
//
// lhs (P, R, K) f32, base (S, base_rows, C) f32, slab (P,) and row (K,)
// int64, acc and out (P, R, C) f32, all contiguous.  The closures name the
// rhs rows of their length state L in place (slab = the productions' C
// operands, row = the active or context rows), so no gathered copy of L's
// rows exists.
//
// Exactness.  Every candidate is one f32 add, rounded to nearest
// (__fadd_rn: no contraction, and there is no multiply), and min is exact
// in any order and over any segments of a long row, so the result equals
// the plain version's bit for bit.  An lhs entry that is not finite is
// skipped: +inf gives only +inf candidates.  Lengths are >= 0 (a NaN or a
// negative infinity is outside the domain; the plain version would differ
// on one).
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; 67e12 float32 operations/s
// outside the tensor cores), counting what the inputs need.  Bytes: the
// lhs read once, of the rhs only the rows (s, r) that some finite lhs entry
// names, acc read once and out written once.  Operations: an add and a min
// per finite lhs entry per output column.  The closures' lhs is mostly
// inf: at R = 991, C = 15,872 (the dense single-path closure of one pizza
// copy) the output alone, (6, 991, 15,872) f32 = 377 MB, takes 0.113 ms,
// and the product is bound by bytes; the design (sparse_rows.cuh) reads
// each lhs word once per column split (2 splits there) and a row index only
// for a finite entry.
// A fully finite lhs of the same shape is bound by operations at 2.8 ms;
// there every entry costs its rhs row slice per warp, mostly from L2 (a
// register-tiled dense path would reuse rhs rows across a block's rows;
// not written).
#include "sparse_rows.cuh"

namespace {

using sparse_rows::i64;

struct MinPlusRing {
  using T = float;
  using V4 = float4;
  static __device__ T zero() { return __int_as_float(0x7f800000); }  // +inf
  static __device__ V4 zero4() {
    return make_float4(zero(), zero(), zero(), zero());
  }
  static __device__ V4 make4(T a, T b, T c, T d) {
    return make_float4(a, b, c, d);
  }
  static __device__ bool take(T v) { return v < zero(); }
  static __device__ int bits(T v) { return __float_as_int(v); }
  static __device__ T value(int b) { return __int_as_float(b); }
  static __device__ T step(T a, T v, T x) { return fminf(a, __fadd_rn(v, x)); }
};

template <bool kVec, bool kAcc>
__global__ void __launch_bounds__(sparse_rows::kThreads,
                                  kVec ? sparse_rows::kMinBlocks
                                       : sparse_rows::kScalarMinBlocks)
minplus_kernel(const float* __restrict__ lhs, const float* __restrict__ base,
               const i64* __restrict__ slab, const i64* __restrict__ row,
               const float* __restrict__ acc, float* __restrict__ out, int R,
               int K, int C, int base_rows, int splits,
               int span) {
  sparse_rows::product_row<MinPlusRing, kVec, kAcc>(
      lhs, base, slab, row, acc, out, R, K, C, base_rows, splits, span);
}

// [16-byte columns][acc given]
const sparse_rows::RowsKernel<float> kKernels[2][2] = {
    {minplus_kernel<false, false>, minplus_kernel<false, true>},
    {minplus_kernel<true, false>, minplus_kernel<true, true>}};

}  // namespace

// out = min(acc, lhs (min,+) base[slab][:, row]) on ``stream`` (see the
// header); slab, row and acc may be null.  Returns a CUDA error code (0:
// launched).  Shapes: lhs (P, R, K), base (S, base_rows, C), out (P, R, C);
// the wrapper has checked them and the index ranges.  Needs
// 1 <= P <= 65,535, R, C >= 1 and K >= 0.
extern "C" int repro_minplus(const void* lhs, const void* base,
                             const void* slab, const void* row,
                             const void* acc, void* out, int P, int R, int K,
                             int C, int base_rows, void* stream) {
  return sparse_rows::launch<float>(kKernels, lhs, base, slab, row, acc, out,
                                  P, R, K, C, base_rows, stream);
}
